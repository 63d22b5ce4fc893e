"""Rich results table (equivalent of reference tools/pipeline_results.py:31-79)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class _Metric:
    desc: str
    units: str
    value: float
    trunc: bool = False


@dataclass
class PipelineResults:
    metrics: List[_Metric] = field(default_factory=list)

    def empty(self) -> bool:
        return not self.metrics

    def append(self, desc: str, units: str, value: float, trunc: bool = False):
        self.metrics.append(_Metric(desc, units, value, trunc))

    def _rich_table(self, title=None):
        from rich.table import Table

        table = Table(title=title, show_header=True, header_style="bold")
        table.add_column("Metric")
        table.add_column("Value", justify="right")
        table.add_column("Units")
        for m in self.metrics:
            value = f"{m.value:.0f}" if m.trunc else f"{m.value:.3f}"
            table.add_row(m.desc, value, m.units)
        return table

    def print_(self):
        if self.empty():
            return
        from rich.console import Console

        Console().print(self._rich_table())

    def log_to_file(self, filename, title):
        if self.empty():
            return
        from rich.console import Console

        with open(filename, "w") as f:
            Console(file=f, width=100, force_jupyter=False).print(
                self._rich_table(title)
            )

    def as_dict(self) -> dict:
        return {m.desc: m.value for m in self.metrics}

    def as_dict_with_units(self) -> dict:
        """{ 'desc [units]': value } — for tables whose header must carry
        the unit (a bare 'Average Runtime' column is ambiguous in scale)."""
        return {
            (f"{m.desc} [{m.units}]" if m.units else m.desc): m.value
            for m in self.metrics
        }
