"""The paper's toy experiments (Tables 1 and 6) in PyTorch: port of
``manipose_tpu/toy/`` without its plots (``plots.py``, ``paper_figures.py``).
The distributions, datasets and metrics are numpy; the models, their
training and the diffusion baseline run on the card unless the caller asks
for the CPU. ``python -m manipose_tpu_torch.toy.main [overrides]``."""

from .datasets import LiftingDataset, LiftingDatasetV2
from .diffusion import LiftingDiffusionModel, compute_noise_scheduling
from .distributions import (
    BivariateVonMisesMixture,
    EasyDist,
    HardBimodalDist,
    HardQuadmodalDist,
    HardUnimodalDist,
    LiftingDist1Dto2D,
    LiftingDist2Dto3D,
    MixtureVonMises,
    torus_angles_to_cartesian,
    torus_cartesian_to_angles,
    torus_scenario,
)
from .metrics import (
    calc_mpjpe,
    calc_mpjpe_3d,
    distance_to_circle,
    oracle_multihyp_mpjpe,
    std_length,
)
from .models import (
    ConstrainedMlp,
    ConstrainedMlpRmcl,
    ConstrainedMlpRmclV2,
    ConstrainedMlpV2,
    ToyMlp,
    aggregate_toy_hypotheses,
    init_toy_model,
    wta_with_scoring_l2_loss,
    wta_with_scoring_l2_loss_v2,
)
from .trainer import ToyTrainer, ToyTrainerConfig
