"""The card's published peaks (``peaks.json``), by the name that
``torch.cuda.get_device_name()`` gives."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

_TABLE = Path(__file__).with_name("peaks.json")


def for_device(kind: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named ``kind``, or None when the table has
    no such card (a share of a peak is then not reported)."""
    with open(_TABLE) as f:
        return json.load(f).get(kind)
