"""Parameter counts for the three model families
(reference: hpe/useful_aux_scripts/count_n_params.py).

The port's copy of ``tools/count_n_params.py``:

  python -m manipose_tpu_torch.tools.count_n_params [model.channels=512 ...]

It counts every parameter of the port's module, which is what the JAX
tool counts (every flax variable): the port's models register no buffer,
and the zero-padding of narrow head dims on the card happens at call time,
on copies. Counting needs no device: the models are built on the host.
"""

from __future__ import annotations

import sys
from typing import Dict

from torch import nn

ARCHS = ("mixste", "manifold", "rmcl_manifold")


def count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def main(argv=None) -> Dict[str, int]:
    """Print and return {arch: parameter count} under the config overrides
    ``argv`` (the command line's by default)."""
    from ..config import load_config
    from ..drivers.common import instantiate_model
    from ..geometry import h36m_skeleton_17

    overrides = sys.argv[1:] if argv is None else list(argv)
    skel = h36m_skeleton_17()
    result = {}
    for arch in ARCHS:
        cfg = load_config("config", overrides=[f"model.arch={arch}", *overrides])
        model, _ = instantiate_model(cfg, skel)
        result[arch] = count(model)
        print(f"{arch}: {result[arch]:,} params")
    return result


if __name__ == "__main__":
    main()
