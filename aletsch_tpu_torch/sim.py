"""Synthetic RNA-seq read simulator writing sorted BAMs (test/bench input)."""

import random

from aletsch_tpu_torch.io.bam import BamWriter, CMATCH, CREF_SKIP


def cum_lengths(exons):
    cl = [0]
    for a, b in exons:
        cl.append(cl[-1] + (b - a))
    return cl


def map_to_genome(exons, tstart, length):
    """Transcript interval [tstart, tstart+length) -> (gpos, cigar)."""
    cl = cum_lengths(exons)
    total = cl[-1]
    assert 0 <= tstart and tstart + length <= total
    cigar = []
    gpos = None
    remaining = length
    t = tstart
    for i, (a, b) in enumerate(exons):
        if t >= cl[i + 1]:
            continue
        off = t - cl[i]
        g = a + off
        if gpos is None:
            gpos = g
        take = min(b - g, remaining)
        if cigar:
            # intron between previous exon end and this exon start
            prev_end = exons[i - 1][1]
            cigar.append((CREF_SKIP, a - prev_end))
        cigar.append((CMATCH, take))
        remaining -= take
        t += take
        if remaining == 0:
            break
    assert remaining == 0
    return gpos, cigar


def simulate_pairs(exons, n_pairs, strand, rng, read_len=100,
                   frag_lo=220, frag_hi=380, prefix="rp", library=None):
    """Paired-end fragments from one isoform; returns record dicts.

    library=None emits fixed R1-leftmost flags (reads as unstranded);
    library="fr_first" emits dUTP-convention flags (leftmost read is R2 for
    '+' transcripts, R1 for '-'), so the previewer infers FR_FIRST.
    """
    cl = cum_lengths(exons)
    total = cl[-1]
    recs = []
    for i in range(n_pairs):
        flen = rng.randint(frag_lo, min(frag_hi, total))
        start = rng.randint(0, total - flen)
        g1, c1 = map_to_genome(exons, start, read_len)
        g2, c2 = map_to_genome(exons, start + flen - read_len, read_len)
        end2 = g2 + sum(l for op, l in c2)
        isize = end2 - g1
        qname = "%s.%d" % (prefix, i)
        xs1 = strand if any(op == CREF_SKIP for op, _ in c1) else "."
        xs2 = strand if any(op == CREF_SKIP for op, _ in c2) else "."
        if library == "fr_first":
            if strand == "+":
                fl1 = 0x1 | 0x2 | 0x20 | 0x80       # left: R2 forward
                fl2 = 0x1 | 0x2 | 0x10 | 0x40       # right: R1 reverse
            else:
                fl1 = 0x1 | 0x2 | 0x20 | 0x40       # left: R1 forward
                fl2 = 0x1 | 0x2 | 0x10 | 0x80       # right: R2 reverse
        else:
            fl1 = 0x1 | 0x2 | 0x20 | 0x40
            fl2 = 0x1 | 0x2 | 0x10 | 0x80
        recs.append(dict(qname=qname, flag=fl1, pos=g1,
                         cigar=c1, mpos=g2, isize=isize, xs=xs1))
        recs.append(dict(qname=qname, flag=fl2, pos=g2,
                         cigar=c2, mpos=g1, isize=-isize, xs=xs2))
    return recs


def write_bam(path, recs, names=("chr1",), lengths=(1000000,)):
    from aletsch_tpu_torch.io.bam import parse_cigar
    for r in recs:
        if isinstance(r["cigar"], str):
            r["cigar"] = parse_cigar(r["cigar"])
    recs = sorted(recs, key=lambda r: (r.get("tid", 0), r["pos"],
                                       sum(l for op, l in r["cigar"])))
    with BamWriter(path, list(names), list(lengths)) as w:
        for r in recs:
            w.write_rec(r["qname"], r["flag"], r.get("tid", 0), r["pos"],
                        r.get("mapq", 60),
                        r["cigar"], mtid=r.get("mtid", r.get("tid", 0)),
                        mpos=r["mpos"], isize=r["isize"],
                        xs=r.get("xs", "."), nh=r.get("nh", 1))
    # a path may be rewritten mid-process (tests/fuzz): stale thread-cached
    # readers must re-stat it
    from aletsch_tpu_torch.io.bam_native import invalidate_cached_readers
    invalidate_cached_readers()


# ---------------------------------------------------------------------------
# adversarial loci: structures the clean generator above never produces.
# These create mixed-strand splice-graph vertices (the one shape the
# scallop resolution ladder cannot decompose, scallop.cc:47-173), NH>1
# multi-alignment webs through the eliminate path (bundle_base.cc:613-679),
# and coverage cliffs at min_subregion_gap borders.


def chain_of(exons):
    """Intron chain of an exon list (matching tools' chain convention)."""
    return tuple((exons[k - 1][1], exons[k][0])
                 for k in range(1, len(exons)))


def make_adversarial_locus(rng, pos, prefix, kind, depth=40, truth=None):
    """Return (records, span) for one adversarial locus starting near pos.
    When `truth` (a list) is given, the locus's true intron chains are
    appended to it as (kind, chain) pairs (tools/soak_adversarial.py's
    per-kind recall accounting; 'cliff' contributes no chains).

    kind:
      'overlap'   two spliced genes on opposite strands sharing the locus
                  (unstranded library => one bundle with conflicting XS
                  junction strands => mixed-strand vertices => greedy DP)
      'xsconf'    one gene whose junction reads carry conflicting XS tags
      'multimap'  NH>1 pairs duplicated across two sites of the locus
      'cliff'     single exon with an abrupt internal coverage cliff
    """
    recs = []
    if kind == "overlap":
        ne = rng.randint(3, 5)
        p = pos
        exons_p = []
        for _ in range(ne):
            el = rng.randint(150, 400)
            exons_p.append((p, p + el))
            p += el + rng.randint(300, 900)
        # '-' gene staggered so its exons/introns interleave with '+'
        q = pos + rng.randint(80, 220)
        exons_m = []
        for _ in range(ne):
            el = rng.randint(150, 400)
            exons_m.append((q, q + el))
            q += el + rng.randint(300, 900)
        recs += simulate_pairs(exons_p, depth, "+", rng,
                               prefix=prefix + "p")
        recs += simulate_pairs(exons_m, depth, "-", rng,
                               prefix=prefix + "m")
        if truth is not None:
            truth.append((kind, chain_of(exons_p)))
            truth.append((kind, chain_of(exons_m)))
        span = max(p, q) - pos
    elif kind == "xsconf":
        ne = rng.randint(3, 4)
        p = pos
        exons = []
        for _ in range(ne):
            el = rng.randint(150, 400)
            exons.append((p, p + el))
            p += el + rng.randint(300, 900)
        recs += simulate_pairs(exons, depth, "+", rng, prefix=prefix + "a")
        # a minority of junction reads tagged with the opposite strand
        bad = simulate_pairs(exons, max(4, depth // 5), "-", rng,
                             prefix=prefix + "x")
        recs += bad
        if truth is not None:
            truth.append((kind, chain_of(exons)))
        span = p - pos
    elif kind == "multimap":
        ne = 3
        p = pos
        exons = []
        for _ in range(ne):
            el = rng.randint(150, 300)
            exons.append((p, p + el))
            p += el + rng.randint(300, 600)
        shift = p - pos + rng.randint(500, 1500)
        exons2 = [(a + shift, b + shift) for a, b in exons]
        prim = simulate_pairs(exons, depth, "+", rng, prefix=prefix + "u")
        recs += prim
        # the same qnames aligned again at the shifted copy with NH=2
        for r in prim:
            recs.append(dict(r, pos=r["pos"] + shift,
                             mpos=r["mpos"] + shift, nh=2,
                             flag=r["flag"] | 0x100))
        for r in prim:
            r["nh"] = 2
        recs += simulate_pairs(exons2, depth // 2, "+", rng,
                               prefix=prefix + "v")
        if truth is not None:
            truth.append((kind, chain_of(exons)))
            truth.append((kind, chain_of(exons2)))
        span = exons2[-1][1] + 500 - pos
    elif kind == "cliff":
        el = rng.randint(900, 1400)
        exon = [(pos, pos + el)]
        # deep left shoulder, shallow right: a cliff inside one region
        half = [(pos, pos + el // 2)]
        recs += simulate_pairs(exon, depth // 4, "+", rng,
                               prefix=prefix + "c", frag_lo=200,
                               frag_hi=min(360, el))
        recs += simulate_pairs(half, depth, "+", rng, prefix=prefix + "d",
                               frag_lo=200, frag_hi=min(360, el // 2))
        span = el
    else:
        raise ValueError(kind)
    return recs, span


ADVERSARIAL_KINDS = ("overlap", "xsconf", "multimap", "cliff")


def simulate_adversarial_sample(path, seed, n_loci=8, start=100000,
                                names=("chr1",), lengths=(40_000_000,),
                                kinds=ADVERSARIAL_KINDS):
    """A chromosome of adversarial loci (one bundle each)."""
    rng = random.Random(seed)
    recs = []
    pos = start
    for i in range(n_loci):
        kind = kinds[i % len(kinds)]
        r, span = make_adversarial_locus(rng, pos, "s%dl%d" % (seed, i),
                                         kind)
        recs += r
        pos += span + rng.randint(20000, 40000)
    write_bam(path, recs, names, lengths)
    return recs


# standard two-gene test genome on chr1
GENE_A_ISO1 = [(10000, 10300), (15000, 15200), (20000, 20400)]
GENE_A_ISO2 = [(10000, 10300), (20000, 20400)]
GENE_B_ISO1 = [(100000, 100500), (105000, 105600)]


def sentinel_target(recs, names, lengths):
    """Append a trailing dummy target carrying one mapped single-end read.

    Works around a reference-binary quirk: set_batch_boundaries
    (rnacore/sample_profile.cc:167-252) never closes the
    final region of the final target (end1 stays 0), so reference Aletsch
    silently skips it.  A sentinel target makes the reference process
    every real chromosome; the sentinel bundle itself is dropped by
    min_num_hits_in_bundle on both implementations.  Used by the golden
    harness (tools/refbuild/compare.py)."""
    tid = len(names)
    recs = list(recs) + [dict(qname="sentinel", flag=0, tid=tid, pos=1000,
                              cigar=[(0, 100)], mtid=tid, mpos=1000,
                              isize=0, xs=".")]
    return recs, tuple(names) + ("chrS",), tuple(lengths) + (10000,)


def simulate_sample(path, seed, n1=60, n2=25, n3=50, names=("chr1",),
                    lengths=(1000000,), sentinel=False):
    rng = random.Random(seed)
    recs = []
    recs += simulate_pairs(GENE_A_ISO1, n1, "+", rng, prefix="a%d" % seed)
    recs += simulate_pairs(GENE_A_ISO2, n2, "+", rng, prefix="b%d" % seed)
    recs += simulate_pairs(GENE_B_ISO1, n3, "-", rng, prefix="c%d" % seed)
    if sentinel:
        recs, names, lengths = sentinel_target(recs, names, lengths)
    write_bam(path, recs, names, lengths)
    return recs
