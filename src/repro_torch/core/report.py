"""Report emission: CSV rows and markdown tables (the port's copy of the
reference's ``core/report.py``)."""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024 or unit == "TB":
            return f"{b:.2f}{unit}"
        b /= 1024
    return f"{b:.2f}TB"


def fmt_si(x: float, suffix: str = "") -> str:
    for scale, p in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(x) >= scale:
            return f"{x / scale:.2f}{p}{suffix}"
    return f"{x:.2f}{suffix}"


def fmt_time(t: float) -> str:
    if t >= 1.0:
        return f"{t:.2f}s"
    if t >= 1e-3:
        return f"{t * 1e3:.2f}ms"
    return f"{t * 1e6:.1f}us"


def markdown_table(headers: Sequence[str], rows: Iterable[Sequence]) -> str:
    lines = ["| " + " | ".join(headers) + " |",
             "|" + "|".join("---" for _ in headers) + "|"]
    for r in rows:
        lines.append("| " + " | ".join(str(c) for c in r) + " |")
    return "\n".join(lines)


def csv_lines(headers: Sequence[str], rows: Iterable[Sequence]) -> List[str]:
    out = [",".join(headers)]
    for r in rows:
        out.append(",".join(str(c) for c in r))
    return out


def save_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, default=str)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)
