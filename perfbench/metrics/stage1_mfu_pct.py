"""The stage-1 step's model FLOPs over the float32 peak.

Counted from the layer widths and the batch, not from the kernels run.
A step on B sampled rows runs: the flow forward (sampling), the flow's
log-probability forward and backward, the NQS forward on the batch, the
NQS forward on the local-energy rows (the whole space and one dense
H @ psi on the ``dense`` route; B * C connected rows otherwise), and the
NQS forward and backward on the batch.  A linear layer costs 2 * in * out
FLOPs a row forward and twice that backward.
"""

from perfbench.peaks import F32_FLOP_PER_S


def step_flops(r, n_connections=None):
    flow = sum(2 * i * o for i, o in r["flow"])
    w = r["nqs_widths"]
    nqs = sum(2 * i * o for i, o in zip(w[:-1], w[1:]))
    B, N = r["batch"], r["n_valid"]
    flops = B * flow + 3 * B * flow + B * nqs + 3 * B * nqs
    if r["route"] == "dense":
        flops += N * nqs + 2 * N * N
    else:
        flops += B * n_connections * nqs
    return flops


def read(ctx):
    recs = [r for r in ctx.records if r.get("epoch_s")]
    if not ctx.on_card or not recs or any(r["route"] != "dense" for r in recs):
        return None
    flops = sum(step_flops(r) * len(r["epoch_s"]) for r in recs)
    seconds = sum(sum(r["epoch_s"]) for r in recs)
    return 100.0 * flops / seconds / F32_FLOP_PER_S
