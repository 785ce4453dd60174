"""Minimal ASCII table formatter (port of :mod:`qcmrf_tpu.utils.table`):
the box format of ``prettytable`` without the dependency."""

from __future__ import annotations

from typing import List, Sequence


def format_table(header: Sequence[str], rows: List[Sequence[str]]) -> str:
    cols = [[str(h)] + [str(r[i]) for r in rows] for i, h in enumerate(header)]
    widths = [max(len(c) for c in col) for col in cols]

    def hline():
        return "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def fmt_row(cells):
        return (
            "|"
            + "|".join(
                f" {str(c):^{w}} " for c, w in zip(cells, widths)
            )
            + "|"
        )

    out = [hline(), fmt_row(header), hline()]
    for r in rows:
        out.append(fmt_row(r))
    out.append(hline())
    return "\n".join(out)
