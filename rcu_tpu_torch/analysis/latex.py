"""The paper tables' LaTeX: the text that pandas 3's ``DataFrame.to_latex()``
writes for the JAX tools' frames, which ``pd.concat(parts, axis=1,
keys=...)`` joins under a two-level column header.

A part is ``(index, columns)``: a list of row labels and an ordered
``{name: np.ndarray}``. The joined rows are the union of the parts' rows,
each part's rows in order and then the next part's new ones; a part's
cell on a row it lacks is NaN. The text:

    \\begin{tabular}{l...}        l for the index and string columns,
    \\toprule                     r for float columns
     & \\multicolumn{n}{r}{key} ...   (the bare key where n is 1)
     & <column> ...
    test_id &  & ...             (the index's name)
    \\midrule
    <row> & <cell> ...           floats %.6f, missing cells NaN
    \\bottomrule
    \\end{tabular}
"""
from __future__ import annotations

import numpy as np


def _cell(value) -> str:
    if isinstance(value, str):
        return value
    if value != value:
        return "NaN"
    return "%.6f" % value


def _line(cells) -> str:
    return " & ".join(cells) + " \\\\"


def to_latex(parts: dict) -> str:
    """``parts``: ``{key: (index, columns)}`` in column order; the rows'
    index is named ``test_id``, as the JAX tools' ``groupby`` names it."""
    index = []
    for part_index, _ in parts.values():
        for row in part_index:
            if row not in index:
                index.append(row)
    header, names, fmt, cells = [], [], ["l"], []
    for key, (part_index, cols) in parts.items():
        n = len(cols)
        header.append(key if n == 1 else f"\\multicolumn{{{n}}}{{r}}{{{key}}}")
        at = {r: i for i, r in enumerate(part_index)}
        for name, values in cols.items():
            names.append(name)
            values = np.asarray(values)
            fmt.append("r" if values.dtype.kind == "f" else "l")
            cells.append([_cell(values[at[r]]) if r in at else "NaN"
                          for r in index])
    lines = [f"\\begin{{tabular}}{{{''.join(fmt)}}}", "\\toprule",
             _line([""] + header), _line([""] + names)]
    lines.append(_line(["test_id"] + [""] * len(names)))
    lines.append("\\midrule")
    for i, row in enumerate(index):
        lines.append(_line([row] + [col[i] for col in cells]))
    lines += ["\\bottomrule", "\\end{tabular}", ""]
    return "\n".join(lines)
