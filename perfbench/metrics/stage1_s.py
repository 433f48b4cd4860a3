"""Seconds of the pipeline's own ``stage1_train`` span, a solve."""


def read(ctx):
    spans = [r["stage_s"]["stage1_train"] for r in ctx.records
             if "stage1_train" in r.get("stage_s", {})]
    return sum(spans) / len(spans) if spans else None
