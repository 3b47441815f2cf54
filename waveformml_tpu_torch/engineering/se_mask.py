"""Single-ended segment status maps (the port's copy of
waveformml_tpu/engineering/se_mask.py).

The dead-PMT channel list and seg_status/blind maps are detector facts the
reference hard-codes (ref: src/evaluation/SingleEndedEvaluator.py:17-37):
seg_status is 0 for good, 0.5 for single-ended (one dead PMT), 1 for dead.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from waveformml_tpu_torch.detector import NX, NY

#: default dead PMT channels (ref: SingleEndedEvaluator.py:17-21)
SE_DEAD_PMTS = [1, 0, 2, 4, 6, 7, 9, 10, 12, 13, 16, 19, 20, 21, 22, 24, 26, 27,
                34, 36, 37, 43, 46, 48, 55, 54, 56, 58, 65, 68, 72, 80, 82, 85,
                88, 93, 95, 97, 96, 105, 111, 112, 120, 122, 137, 138, 139, 141,
                147, 158, 166, 173, 175, 188, 195, 215, 230, 243, 244, 245, 252,
                255, 256, 261, 273, 279, 282]


def seg_status_maps(dead_pmts: Optional[Sequence[int]] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (seg_status[NX,NY], blind_detl[NX,NY], blind_detr[NX,NY])."""
    pmts = SE_DEAD_PMTS if dead_pmts is None else dead_pmts
    seg_status = np.zeros((NX, NY), dtype=np.float32)
    blind_detl = np.zeros((NX, NY), dtype=np.int8)
    blind_detr = np.zeros((NX, NY), dtype=np.int8)
    for pmt in pmts:
        r = pmt % 2
        seg = (pmt - r) // 2
        x, y = seg % NX, seg // NX
        seg_status[x, y] += 0.5
        if r == 0:
            blind_detl[x, y] = 1
        else:
            blind_detr[x, y] = 1
    return seg_status, blind_detl, blind_detr


def se_loss_mask(dead_pmts: Optional[Sequence[int]] = None) -> np.ndarray:
    """[NX, NY] mask: 1 at single-ended segments, 0 at good/dead segments
    (ref: LitBase.py:111-122 _format_SE_mask)."""
    seg_status, _, _ = seg_status_maps(dead_pmts)
    mask = np.zeros_like(seg_status)
    mask[seg_status == 0.5] = 1.0
    return mask
