"""Minimal ASCII table, replacing the reference's PrettyTable dependency
(reference: src/offline_evaluation/compute_probabilistic_metrics.py:178-205).
The port's copy of ``pod_compare_tpu/utils/table.py``."""

from typing import Iterable, List, Sequence


class Table:
    """ASCII table with PrettyTable-compatible `field_names` / `add_row` API."""

    def __init__(self, field_names: Sequence[str] = ()):
        self.field_names: List[str] = list(field_names)
        self._rows: List[List[str]] = []

    def add_row(self, row: Iterable) -> None:
        row = [str(x) for x in row]
        if self.field_names and len(row) != len(self.field_names):
            raise ValueError(
                f"Row has {len(row)} values, expected {len(self.field_names)}"
            )
        self._rows.append(row)

    def __str__(self) -> str:
        cols = self.field_names or (self._rows[0] if self._rows else [])
        ncol = len(cols)
        widths = [len(str(c)) for c in cols]
        for row in self._rows:
            for i in range(ncol):
                widths[i] = max(widths[i], len(row[i]))
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        out = [sep]
        if self.field_names:
            out.append(
                "|"
                + "|".join(f" {c:^{w}} " for c, w in zip(self.field_names, widths))
                + "|"
            )
            out.append(sep)
        for row in self._rows:
            out.append(
                "|" + "|".join(f" {c:^{w}} " for c, w in zip(row, widths)) + "|"
            )
        out.append(sep)
        return "\n".join(out)
