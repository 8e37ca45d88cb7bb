"""ladder.live_row_share (%; layer: ladder solver): the useful share of
the rows the ladder's launches run, 100 x ladder_graphs /
ladder_rows_shipped of the device stats (ops/ladder_device.py: the live
rows, and the rows run, switched-off ones up to a card's power of two
included) a pass, the mean over the passes where the ladder dispatched.
None on a program without the rows counter."""

from bmk.readers import per_pass


def pass_live_row_share(p):
    shipped = p.stats.get("ladder_rows_shipped")
    if not shipped or p.stats.get("ladder_dispatches", 0) <= 0:
        return None
    return 100.0 * p.stats["ladder_graphs"] / shipped


def read(run):
    return per_pass(run, pass_live_row_share)
