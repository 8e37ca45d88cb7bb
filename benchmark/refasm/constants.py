"""Shared constants for aletsch-tpu.

Mirrors the semantic vocabulary of the reference assembler
(util/constants.h:21-104): boundary types, vertex-decompose
types, library types, data types, transcript-merge modes.  Values are kept
identical so that configs and intermediate dumps are comparable.
"""

# boundary types (constants.h:21-28)
START_BOUNDARY = 1
END_BOUNDARY = 2
LEFT_SPLICE = 3
RIGHT_SPLICE = 4
LEFT_RIGHT_SPLICE = 5
MIDDLE_CUT = 6
LEFT_MIXED = 7
RIGHT_MIXED = 8

# graph classification (constants.h:30-31)
TRIVIAL = 0
NORMAL = 1

# decomposition types (constants.h:34-46)
SMALLEST_EDGE = 0
NEGLIGIBLE_EDGE = 1
SPLITTABLE_SIMPLE = 2
SPLITTABLE_HYPER = 3
SPLITTABLE_PURE = 4
UNSPLITTABLE_SINGLE = 5
UNSPLITTABLE_MULTIPLE = 6
TRIVIAL_VERTEX = 7
MIXED_DIVIDED = 8
MIXED_BLOCKED = 9
MIXED_TRIVIAL = 10
MIXED_TANGLED = 11
MIXED_SPLITTABLE = 12

EMPTY = -1
UNSTRANDED = 0
FR_FIRST = 1
FR_SECOND = 2

EMPTY_VERTEX = -9

# pairwise relation of two sorted coordinate sequences (constants.h:56-65)
IDENTICAL = 0
FALL_RIGHT = 1
FALL_LEFT = 2
CONTAINED = 3
CONTAINING = 4
EXTEND_RIGHT = 5
EXTEND_LEFT = 6
NESTED = 7
NESTING = 8
CONFLICTING = 9

POSITION_NAMES = [
    "identical", "fall-right", "fall-left", "contained", "containing",
    "extend_right", "extend_left", "nested", "nesting", "conflicting",
]

# transcript merge modes (constants.h:68-70)
TRANSCRIPT_COUNT_ADD_COVERAGE_ADD = 1
TRANSCRIPT_COUNT_ADD_COVERAGE_NUL = 2
TRANSCRIPT_COUNT_MAX_COVERAGE_MAX = 3

# RNA-seq data types (constants.h:73-79)
NUM_DATA_TYPES = 6
DEFAULT = 0
PAIRED_END = 1
SINGLE_END = 2
PACBIO_CCS = 3
PACBIO_SUB = 4
ONT = 5

DATA_TYPE_NAMES = {
    "paired_end": PAIRED_END,
    "single_end": SINGLE_END,
    "pacbio_ccs": PACBIO_CCS,
    "pacbio_sub": PACBIO_SUB,
    "ont": ONT,
}

SMIN = 1e-8   # numeric epsilon used in weight comparisons (same role as SMIN)
