"""The four JSON output files of a run, as the reference CLI writes them:

- ``raw_coordinates.json``: ``json.dump(coordinates, default=float)``'s text;
- ``raw_data.json`` and ``processed_data.json``: the Processor's tables as
  ``DataFrame.to_json(orient="records")`` writes them -- one object per
  row, the index dropped, columns in order, tuples as lists, NaN and None
  as ``null``, floats with pandas' 10 decimal places -- without pandas;
- ``metadata.json``: ``json.dump({"fps", "team_mapping"}, default=str)``.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

#: above this magnitude pandas writes floats in the shortest exponent form
_FIXED_MAX = 1e16


def _float(v: float) -> str:
    if not math.isfinite(v):
        return "null"
    if abs(v) > _FIXED_MAX:
        return repr(v)
    s = f"{v:.10f}".rstrip("0")
    return s + "0" if s.endswith(".") else s


def _dump(v, out: list) -> None:
    if v is None:
        out.append("null")
    elif isinstance(v, (bool, np.bool_)):
        out.append("true" if v else "false")
    elif isinstance(v, (int, np.integer)):
        out.append(str(int(v)))
    elif isinstance(v, (float, np.floating)):
        out.append(_float(float(v)))
    elif isinstance(v, str):
        out.append(json.dumps(v))
    elif isinstance(v, dict):
        out.append("{")
        for i, (k, x) in enumerate(v.items()):
            if i:
                out.append(",")
            out.append(json.dumps(str(k)) + ":")
            _dump(x, out)
        out.append("}")
    elif isinstance(v, (list, tuple, np.ndarray)):
        out.append("[")
        for i, x in enumerate(v):
            if i:
                out.append(",")
            _dump(x, out)
        out.append("]")
    else:
        raise TypeError(f"cannot write {type(v).__name__} to a records table")


def dumps_records(records: list[dict]) -> str:
    """A list of row dicts as ``to_json(orient="records")`` writes it."""
    out: list[str] = []
    _dump(list(records), out)
    return "".join(out)


def write_outputs(root: str, fps: int, coordinates: dict, table, team_mapping: dict, processed: list[dict]) -> None:
    """Write ``raw_coordinates.json``, ``raw_data.json`` (``table``, a
    :class:`eagle_tpu_torch.pipeline.processor.Table`), ``metadata.json``
    and ``processed_data.json`` (the records of ``Processor.format_data``)
    into the directory ``root``."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "raw_coordinates.json"), "w") as f:
        f.write(json.dumps(coordinates, default=float))
    with open(os.path.join(root, "raw_data.json"), "w") as f:
        f.write(dumps_records(table.records()))
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump({"fps": fps, "team_mapping": team_mapping}, f, default=str)
    with open(os.path.join(root, "processed_data.json"), "w") as f:
        f.write(dumps_records(processed))
