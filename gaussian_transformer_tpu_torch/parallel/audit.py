"""Collective audit: check that a step issued the collectives the sharding
design intends (port of ``gaussian_transformer_tpu/parallel/audit.py``).

The Gaussian-sharded step should move the SMALL projected splat
representation (all-gathers of [C, few] float32) and the gradient
reductions; it must NOT all-gather the raw learnable parameters (that would
make primitive sharding pointless). The JAX package reads the collectives
out of a compiled step's HLO text; the port issues its collectives itself,
so ``collective_report`` reads the record that ``collectives.recording()``
kept of one run (forward and backward). ``hlo_of_compiled`` has no
counterpart: there is no compiled program to read.
"""

from __future__ import annotations

from typing import Iterable, List

from gaussian_transformer_tpu_torch.parallel.collectives import Collective

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "collective-permute", "all-to-all")


def collective_report(record: Iterable[Collective]) -> List[Collective]:
    """Every collective of a ``recording()``, in issue order."""
    out = list(record)
    for c in out:
        if c.op not in COLLECTIVES:
            raise ValueError(f"unknown collective {c.op!r}")
    return out


def assert_no_large_gathers(report: List[Collective], max_gather_bytes: int):
    """Fail if any all-gather moves more than ``max_gather_bytes``."""
    offenders = [c for c in report if c.op == "all-gather" and c.bytes > max_gather_bytes]
    assert not offenders, (
        "all-gathers exceeding the projected-representation budget "
        f"({max_gather_bytes}B): {offenders}"
    )


def assert_no_param_gathers(report: List[Collective], trailing_dims, min_rows: int):
    """Fail if an all-gather output looks like a raw learnable-parameter
    tensor: trailing dims matching a distinctive parameter leaf (e.g.
    features_rest's (15, 3), rotation's (4,)) with a leading row count >=
    ``min_rows``. The projected representation (rows of 2/3/16 floats)
    never has these trailing shapes."""
    offenders = []
    for c in report:
        if c.op != "all-gather":
            continue
        for dims, s in zip(c.shapes, c.shape_strings()):
            for tail in trailing_dims:
                tail = tuple(tail)
                if len(dims) >= len(tail) + 1 and tuple(dims[-len(tail):]) == tail:
                    rows = 1
                    for d in dims[: -len(tail)]:
                        rows *= d
                    if rows >= min_rows:
                        offenders.append((c.op, s))
    assert not offenders, f"raw-parameter all-gathers detected: {offenders}"


def summarize(report: List[Collective]) -> str:
    lines = [f"  {c.op:20s} {c.bytes / 1e6:10.3f} MB  {', '.join(c.shape_strings()[:4])}" for c in report]
    by_op = {}
    for c in report:
        by_op.setdefault(c.op, [0, 0])
        by_op[c.op][0] += 1
        by_op[c.op][1] += c.bytes
    head = [f"{op}: n={n} total={b / 1e6:.2f}MB" for op, (n, b) in sorted(by_op.items())]
    return "; ".join(head) + "\n" + "\n".join(lines)
