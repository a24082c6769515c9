"""The median served view's latency (request to bytes on the host) over the
traced run's untraced views, in milliseconds."""


def read(r):
    return r.get("view_p50_ms")
