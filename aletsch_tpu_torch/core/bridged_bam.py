"""Writing bridged reads back to BAM.

Parity with the bridged-read BAM writing of rnacore/essential.cc:491-701:
a bridged pair becomes one record spanning [h1.pos, h2.rpos) whose CIGAR
alternates matches and skips along the whole chain; unbridged mates are
written individually with their own chains.
"""

from __future__ import annotations

from ..io.bam import CMATCH, CREF_SKIP


def chain_to_cigar(pos, chain, rpos):
    """[pos] + chain + [rpos] -> alternating M/N ops (build_bam1_t)."""
    z = [pos] + list(chain) + [rpos]
    cigar = []
    for i in range(len(z) - 1):
        x1, x2 = z[i], z[i + 1]
        if x1 >= x2:
            return None
        op = CMATCH if i % 2 == 0 else CREF_SKIP
        cigar.append((op, x2 - x1))
    return cigar


def write_bridged_pereads_cluster(writer, pc, whole):
    """essential.cc:628-652: one merged record per bridged pair."""
    n = 0
    for h1, h2 in zip(pc.hits1, pc.hits2):
        cigar = chain_to_cigar(h1.pos, whole, h2.rpos)
        if cigar is None:
            continue
        xs = h1.xs if h1.xs != "." else h2.xs
        writer.write_rec(h1.qname, h1.flag, h1.tid, h1.pos, h1.qual, cigar,
                         mtid=h1.tid, mpos=0, isize=h2.rpos - h1.pos,
                         xs=xs,
                         nh=h1.nh if (h1.nh != -1 and h1.nh == h2.nh) else None,
                         hi=h1.hi if (h1.hi != -1 and h1.hi == h2.hi) else None)
        n += 1
    return n


def write_unbridged_pereads_cluster(writer, pc):
    """essential.cc:654-681: both mates written with their own chains."""
    n = 0
    for h in list(pc.hits1) + list(pc.hits2):
        chain = pc.chain1 if h in pc.hits1 else pc.chain2
        cigar = chain_to_cigar(h.pos, chain, h.rpos)
        if cigar is None:
            continue
        writer.write_rec(h.qname, h.flag, h.tid, h.pos, h.qual, cigar,
                         mtid=h.mtid, mpos=h.mpos, isize=h.isize,
                         xs=h.xs, nh=h.nh if h.nh != -1 else None)
        n += 1
    return n
