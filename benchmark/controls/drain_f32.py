"""Control drain_f32: the drain in float32, the precision below the
configurations' float64, through the program's own float32 path (the
f32 instance of csrc/drain.cu on a card, drain_torch in float32 on the
CPU): each dispatch's staged weights and scalars go to the drain as
float32 and its path weights come back as float64.  The comparison must
find it: `correct` false.  Runs only where asked (run.py --control
drain_f32), never in a run of the benchmark's own.  calls() counts the
drains it lowered; a control run in which it lowered none in the window
gives no result (bmk/main.py)."""

_SAVED = []
_CALLS = [0]


def install():
    from aletsch_tpu_torch.ops import drain as drain_ops
    orig = drain_ops.drain

    def drain_f32(W, P, sink, scal, maxp):
        _CALLS[0] += 1
        paths, ws, npaths = orig(W.float(), P, sink, scal.float(), maxp)
        return paths, ws.double(), npaths

    drain_ops.drain = drain_f32
    _SAVED.append((drain_ops, orig))


def calls():
    return _CALLS[0]


def remove():
    while _SAVED:
        mod, orig = _SAVED.pop()
        mod.drain = orig
