"""Columnar frames for the analysis tools (``rcu_tpu.analysis.frames``
counterpart, without pandas).

A frame is a ``dict`` of equal-length numpy columns, read from an eval CSV
with the stdlib ``csv`` module. The helpers reproduce the pandas
operations of the JAX tools where their result shows in a printed digit or
a plotted point:

- :func:`stack` in place of ``pd.concat(frames, keys=...)``: the key
  becomes a ``run_id`` column;
- :func:`merge` in place of an inner ``pd.merge``: the left rows' order,
  each left row with its right matches in the right frame's order;
- :func:`group_mean` in place of ``groupby(...).mean()``: keys sorted,
  NaN skipped, and the compensated (Kahan) sum in row order that pandas'
  grouped mean takes, so that a tie between two means is the same tie;
- :func:`parse_float` reads a float as pandas' default C parser does
  (not always the nearest double: it keeps 17 digits and scales by a
  power of ten), so that every parsed value, and every mean and plotted
  point made of them, is the JAX tools' to the bit;
- the masked reliability bins of the calibration CSVs' ``bins_*_00..09``
  columns, the error precision and recall with their 0/0 -> 1
  conventions, and the threshold of a ``<id>_thXXX`` run id.
"""
from __future__ import annotations

import csv
import re

import numpy as np

BINS = 10
_MAX_DIGITS = 17
_POW10 = [float(f"1e{k}") for k in range(309)]
_NUMBER = re.compile(r"([+-]?)([0-9]*)(?:\.([0-9]*))?(?:[eE]([+-]?[0-9]+))?$")


def parse_float(text: str) -> float:
    """The value pandas' default C parser (``precise_xstrtod``) gives
    ``text``: the first 17 digits accumulated as ``x * 10 + digit`` in
    float64, then multiplied or divided by the power of ten of the
    exponent. ``nan``, ``inf`` and exponents past 308 go to ``float``."""
    m = _NUMBER.match(text)
    if m is None or not (m.group(2) or m.group(3)):
        return float(text)
    sign, whole, frac, exp = m.groups()
    number, digits, exponent = 0.0, 0, 0
    for ch in whole:
        if digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    used = (frac or "")[:max(0, _MAX_DIGITS - digits)]
    for ch in used:
        number = number * 10.0 + (ord(ch) - 48)
    exponent -= len(used)
    if sign == "-":
        number = -number
    if exp:
        exponent += int(exp)
    if exponent > 308:
        return float(text)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0 * number
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _column(values: list) -> np.ndarray:
    """A CSV column's text -> bool (``True``/``False`` text), int64, float64
    (an empty cell is NaN) or, failing those, str."""
    if values and all(v in ("True", "False") for v in values):
        return np.array([v == "True" for v in values])
    try:
        return np.array([int(v) for v in values], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.array([parse_float(v) if v else np.nan for v in values],
                        dtype=np.float64)
    except ValueError:
        return np.array(values, dtype=object)


def read_csv(path: str) -> dict:
    """An eval CSV as ``{column: np.ndarray}``, in the file's column order."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: _column([row[j] for row in body])
            for j, name in enumerate(header)}


def n_rows(frame: dict) -> int:
    return len(next(iter(frame.values()))) if frame else 0


def rows(frame: dict, index) -> dict:
    """The rows ``index`` (a boolean mask or positions) of every column."""
    return {k: v[index] for k, v in frame.items()}


def columns(frame: dict, names) -> dict:
    return {k: frame[k] for k in names}


def _joined(parts: list) -> np.ndarray:
    """The parts end to end; as pandas joins them, booleans beside any
    other kind (a NaN fill among them) stay objects."""
    kinds = {p.dtype.kind for p in parts}
    if "O" in kinds or ("b" in kinds and len(kinds) > 1):
        parts = [p.astype(object) for p in parts]
    return np.concatenate(parts)


def stack(frames: list, keys: list, name: str = "run_id") -> dict:
    """The frames' rows one after another, ``name`` = the frame's key on
    each row; a column that a frame lacks is NaN on its rows."""
    names = []
    for frame in frames:
        names.extend(k for k in frame if k not in names)
    out = {name: np.array([key for key, frame in zip(keys, frames)
                           for _ in range(n_rows(frame))], dtype=object)}
    for col in names:
        out[col] = _joined([
            frame[col] if col in frame else np.full(n_rows(frame), np.nan)
            for frame in frames])
    return out


def merge(left: dict, right: dict, on: list) -> dict:
    """Inner join on the ``on`` columns: left's columns, then right's
    others."""
    matches = {}
    right_keys = list(zip(*(right[k] for k in on)))
    for j, key in enumerate(right_keys):
        matches.setdefault(key, []).append(j)
    li, ri = [], []
    for i, key in enumerate(zip(*(left[k] for k in on))):
        for j in matches.get(key, ()):
            li.append(i)
            ri.append(j)
    li, ri = np.array(li, dtype=np.int64), np.array(ri, dtype=np.int64)
    out = {k: v[li] for k, v in left.items()}
    for k, v in right.items():
        if k not in on:
            if k in out:
                raise ValueError(f"column {k!r} on both sides of the merge")
            out[k] = v[ri]
    return out


def unique_sorted(keys) -> list:
    """The distinct keys in pandas' group order (sorted)."""
    return sorted(set(keys.tolist() if isinstance(keys, np.ndarray) else keys))


def group_mean(keys, values) -> tuple:
    """(sorted distinct keys, the mean of ``values`` per key): NaN skipped,
    summed in row order with Kahan's compensation, as pandas' grouped mean
    sums."""
    groups = unique_sorted(keys)
    slot = {k: i for i, k in enumerate(groups)}
    total, comp = [0.0] * len(groups), [0.0] * len(groups)
    count = [0] * len(groups)
    for key, val in zip(keys.tolist(), np.asarray(values, np.float64).tolist()):
        if val != val:
            continue
        g = slot[key]
        count[g] += 1
        y = val - comp[g]
        t = total[g] + y
        comp[g] = t - total[g] - y
        if comp[g] != comp[g]:  # an infinite value: keep the sum infinite
            comp[g] = 0.0
        total[g] = t
    return groups, np.array([t / n if n else np.nan
                             for t, n in zip(total, count)])


def first_max(keys: list, values: np.ndarray):
    """The key of the first largest non-NaN value (``Series.idxmax``)."""
    values = np.asarray(values, np.float64)
    if np.isnan(values).all():
        raise ValueError("Encountered all NA values")
    return keys[int(np.nanargmax(values))]


def _bin_block(frame: dict, name: str) -> np.ndarray:
    return np.stack([frame[f"{name}_{i:02d}"] for i in range(BINS)], axis=1)


def get_bins(frame: dict):
    """(avg_confidence, positive_fraction, counts) as masked arrays over the
    fixed 10-bin columns, masked where bins_non_zero is False."""
    conf = _bin_block(frame, "bins_avg_confidence")
    frac = _bin_block(frame, "bins_positive_fraction")
    nonzero = _bin_block(frame, "bins_non_zero")
    if nonzero.dtype != bool:
        nonzero = nonzero.astype(str) == "True"
    counts = _bin_block(frame, "bins_count").astype(float)
    mask = ~nonzero
    return (np.ma.array(conf, mask=mask), np.ma.array(frac, mask=mask),
            np.ma.array(counts, mask=mask))


def error_recall(fp, fn, fpu, fnu):
    """(fnu + fpu) / (fn + fp), 1 where both are 0
    (``rcu_tpu.analysis.frames.pandas_error_recall``)."""
    undef = ((fnu + fpu) == 0) & ((fn + fp) == 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        result = (fnu + fpu) / (fn + fp)
    result = result.astype(float)
    result[undef] = 1.0
    return result


def error_precision(tpu, tnu, fpu, fnu):
    """(fnu + fpu) / (fnu + fpu + tpu + tnu), 1 where both are 0
    (``rcu_tpu.analysis.frames.pandas_error_precision``)."""
    undef = ((fnu + fpu) == 0) & ((fnu + fpu + tpu + tnu) == 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        result = (fnu + fpu) / (fnu + fpu + tpu + tnu)
    result = result.astype(float)
    result[undef] = 1.0
    return result


def threshold_from_run_id(run_id: str) -> float:
    """The trailing 3-digit threshold code of a ``<id>_thXXX`` run id (the
    eval passes write ``f"{t:.2f}".replace(".", "")``)."""
    return float(run_id[-3:]) / 100


def concat_threshold_frames(data) -> dict:
    """data: iterable of (id_, file_path, threshold-str) -> one frame with
    a ``run_id`` column ``<id>_th<threshold>`` and a float ``threshold``
    column."""
    run_ids, frames = [], []
    for id_, file_path, threshold in data:
        frames.append(read_csv(file_path))
        run_ids.append(f"{id_}_th{threshold}")
    df = stack(frames, run_ids)
    df["threshold"] = np.array([threshold_from_run_id(s)
                                for s in df["run_id"]])
    return df


def dataset_level_reliability(group: dict):
    """Count-weighted dataset-level reliability curve and the per-subject
    ECE recomputed from the bins, which must match the CSV's. Returns
    (avg_conf, pos_frac, per_subject_ece)."""
    conf, frac, counts = get_bins(group)
    bin_sum = counts.sum(axis=0)
    avg_conf = (conf * counts).sum(axis=0) / bin_sum
    pos_frac = (frac * counts).sum(axis=0) / bin_sum
    proportions = counts / counts.sum(axis=1, keepdims=True)
    ece = (np.abs(conf - frac) * proportions).sum(axis=1)
    if not np.allclose(np.asarray(ece), group["ece"], atol=1e-5):
        raise AssertionError("CSV ece does not match bins-recomputed ece")
    return avg_conf, pos_frac, ece
