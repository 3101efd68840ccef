"""Hand-written Hopper kernels, their wrappers and their plain versions.

``LAUNCHES`` counts, per kernel, the launches on the card since it was last
reset: a wrapper adds one where it launches its kernel and nowhere else
(the CPU path through the plain version does not count).
"""
from typing import Dict

LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                             "flash_attention_bwd_dq": 0,
                             "flash_attention_bwd_dkv": 0,
                             "ssd_intra": 0,
                             "rmsnorm": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
