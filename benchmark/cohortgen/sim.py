"""Read simulator: frozen copy of the parts of aletsch_tpu_torch/sim.py
that the cohort builder uses (write_bam without the port's reader-cache
invalidation, which only a process that reads the BAMs back needs)."""

from .bam import CMATCH, CREF_SKIP, BamWriter, parse_cigar


def cum_lengths(exons):
    cl = [0]
    for a, b in exons:
        cl.append(cl[-1] + (b - a))
    return cl


def map_to_genome(exons, tstart, length):
    """Transcript interval [tstart, tstart+length) -> (gpos, cigar)."""
    cl = cum_lengths(exons)
    total = cl[-1]
    if not (0 <= tstart and tstart + length <= total):
        raise ValueError("interval [%d, %d) outside a transcript of %d bp"
                         % (tstart, tstart + length, total))
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


def sentinel_target(recs, names, lengths):
    """Append a trailing dummy target carrying one mapped single-end read.

    Works around a reference-binary quirk: set_batch_boundaries
    (rnacore/sample_profile.cc:167-252) never closes the
    final region of the final target (end1 stays 0), so reference Aletsch
    silently skips it.  A sentinel target makes the reference process
    every real chromosome; the sentinel bundle itself is dropped by
    min_num_hits_in_bundle on both implementations."""
    tid = len(names)
    recs = list(recs) + [dict(qname="sentinel", flag=0, tid=tid, pos=1000,
                              cigar=[(0, 100)], mtid=tid, mpos=1000,
                              isize=0, xs=".")]
    return recs, tuple(names) + ("chrS",), tuple(lengths) + (10000,)
