"""pipeline_run_ms.serve (ms; layer: pipeline, ``pipeline/end_to_end.py``
and ``ops/morphology.py``; moves serve_pages_per_s).

The median of one ``TextRemovalPipeline.run`` on a batch already on the
card, with a synchronize, on the host clock (the runner's
``pipeline_run`` spans)."""

FAMILIES = ()


def read(ctx):
    v = ctx.spans.median("pipeline_run")
    return None if v is None else v * 1e3
