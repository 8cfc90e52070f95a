"""serve_gain_pct.serve (%; layer: server, ``pipeline/serve.py`` and
``data/pipeline.py``; moves serve_pages_per_s).

What ``PageStreamServer`` gains over calling the pipeline one batch at a
time: the closed loop's time per batch (upload, ``run``, a blocking uint8
read-back; the runner's ``closed_loop`` spans on the host clock) over the
window's serve interval per batch, minus 1."""

FAMILIES = ()


def read(ctx):
    closed = ctx.spans.by_name.get("closed_loop")
    interval = ctx.window.get("interval_s")
    if not closed or not interval:
        return None
    return 100.0 * (sum(closed) / len(closed) / interval - 1.0)
