"""feed_starved_pct.serve (%; layer: server, ``data/pipeline.py``; moves
serve_pages_per_s).

100 x the growth of the program's counter ``prefetch.starved`` over that
of ``prefetch.batches`` (``utils/profiling.py::counters``) while the
window profiled with the host traced ran: the share of that window's
batches for which the server found the prefetcher's queue empty. None
where the program keeps no such counters."""

from portbench import parts

FAMILIES = ()


def read(ctx):
    p = parts.of(ctx)
    c = p.counts if p is not None else None
    if not c or not c.get("prefetch.batches"):
        return None
    return 100.0 * c.get("prefetch.starved", 0) / c["prefetch.batches"]
