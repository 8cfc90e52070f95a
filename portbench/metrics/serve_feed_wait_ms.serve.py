"""serve_feed_wait_ms.serve (ms; layer: server, ``pipeline/serve.py``,
``data/pipeline.py``; moves serve_pages_per_s).

The median host time of the program's span ``serve.feed_wait``: the
server waiting on its prefetcher for the next uploaded batch."""

from portbench import parts

FAMILIES = ()


def read(ctx):
    return parts.host_median_ms(ctx, "serve.feed_wait")
