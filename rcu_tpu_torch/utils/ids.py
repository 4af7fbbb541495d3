"""Run ids (``rcu_tpu.utils.ids``, copied): ``yymmdd-HHMMSS``, and a run
name's leading id, which marks a run to resume."""
from __future__ import annotations

import datetime
import re

_FORMAT = "%y%m%d-%H%M%S"
_ID_RE = re.compile(r"^\d{6}-\d{6}")


def unique_identifier() -> str:
    return datetime.datetime.now().strftime(_FORMAT)


def extract_leading_identifier(name: str) -> str:
    """The leading ``yymmdd-HHMMSS`` of a run name, or ''."""
    m = _ID_RE.match(name)
    return m.group(0) if m else ""
