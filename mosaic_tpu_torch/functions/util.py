"""Utility functions: error-wrapped application (try_sql analog).

Port of ``mosaic_tpu/functions/util.py`` (host numpy, as in the reference).

Reference analog: the `TrySql` expression (`expressions/util/TrySql.scala:
12-71`, registered at `functions/MosaicContext.scala:412-416`) which converts
per-row evaluation errors into null results plus an error column.
"""

from __future__ import annotations

from typing import Callable


__all__ = ["try_sql", "try_sql_columnar"]


def try_sql(fn: Callable, *columns, **kwargs):
    """Apply ``fn`` row-by-row; failures become None + an error message.

    Returns ``(results: list, errors: list[str | None])``. The reference
    wraps one expression per query; here any row-wise callable works:

    >>> res, err = try_sql(lambda w: st_area([w])[0], wkts)

    This is deliberately a per-row Python loop — a compatibility shim
    matching the reference's per-row TrySql semantics, NOT a columnar
    fast path: per-row exception isolation is the feature, and it costs
    a Python-level call per row. On clean million-row columns call the
    columnar function directly and use try_sql only to triage the rows
    that failed.
    """
    n = len(columns[0])
    results: list = [None] * n
    errors: list = [None] * n
    for i in range(n):
        args = [c[i] for c in columns]
        try:
            results[i] = fn(*args, **kwargs)
        except Exception as e:  # lint: broad-except-ok (per-row isolation is the point; error recorded per row)
            errors[i] = f"{type(e).__name__}: {e}"
    return results, errors


def try_sql_columnar(fn: Callable, *columns, **kwargs):
    """Columnar ``try_sql``: same null-plus-error contract, batch cost.

    ``fn`` takes whole column slices and returns a sequence of per-row
    results (any of this package's columnar functions qualifies). The
    clean path is ONE vectorized call; on failure the column bisects, so
    isolating k bad rows among n costs O(k log n) vectorized calls
    instead of the n Python-level calls of :func:`try_sql`. Failing rows
    come back as None with the row's error message, exactly like the
    reference's TrySql error column (`expressions/util/TrySql.scala:
    12-71`).
    """
    n = len(columns[0])
    results: list = [None] * n
    errors: list = [None] * n

    def run(lo: int, hi: int) -> None:
        cols = [c[lo:hi] for c in columns]
        try:
            # materialize INSIDE the try: a lazy fn (generator/map) defers
            # its failure to iteration, which must still bisect; a wrong
            # output length would silently misalign rows
            out = list(fn(*cols, **kwargs))
            if len(out) != hi - lo:
                raise ValueError(
                    f"columnar fn returned {len(out)} results for "
                    f"{hi - lo} rows"
                )
        except Exception as e:  # lint: broad-except-ok (bisection isolates the failing row; error recorded)
            if hi - lo == 1:
                errors[lo] = f"{type(e).__name__}: {e}"
                return
            mid = (lo + hi) // 2
            run(lo, mid)
            run(mid, hi)
            return
        for i, v in enumerate(out):
            results[lo + i] = v

    if n:
        run(0, n)
    return results, errors
