"""Helpers tying TranscriptSet construction to config."""

from __future__ import annotations

from ..core.transcript_set import TranscriptSet


def new_transcript_set(chrm, rid, cfg):
    return TranscriptSet(chrm, rid, cfg.min_single_exon_clustering_overlap)
