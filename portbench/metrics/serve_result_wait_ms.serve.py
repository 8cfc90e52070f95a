"""serve_result_wait_ms.serve (ms; layer: server, ``pipeline/serve.py``;
moves serve_pages_per_s).

The median host time of the program's span ``serve.result_wait``: the
server waiting on the event after the oldest batch's copy out."""

from portbench import parts

FAMILIES = ()


def read(ctx):
    return parts.host_median_ms(ctx, "serve.result_wait")
