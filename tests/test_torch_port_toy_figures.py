"""PyTorch port vs the JAX package on the toy paper figures
(``toy/plots.py``, ``toy/paper_figures.py``).

``train_figure_models`` trains the three figure models (mlp, constrained,
constrained_rmcl) on hard-2 for 2 epochs on the CPU from the JAX package's
initial weights (``weights.toy_state_dict_from_jax``) and is held against
the JAX package's at the toy drivers' tolerance of
``tests/test_torch_port_toy.py``, 1e-4 of the magnitude (2 epochs of Adam
from the same weights and batches), for the loss histories and the
predictions. The rMCL model's raw hypotheses are held at 5e-4 (measured
1.85e-4): each head learns from the samples it wins, the win is decided by
head differences that the two sides' one-pass BatchNorm variance
(E[x^2] - E[x]^2 in fp32; the inputs' variance 0.035 against a mean square
of 0.26) moves at fp32 noise, and the aggregated prediction averages the
heads back within 1e-4. Figure 8 draws no trained model: the
port's file is the JAX package's, byte for byte. Figure 4 and the plots of
the JAX toy main are written where the JAX package writes them, as PNGs.
"""

import numpy as np
import pytest

import jax

from manipose_tpu.toy import paper_figures as j_figures
from manipose_tpu.toy.datasets import LiftingDataset as JLiftingDataset
from manipose_tpu.toy.distributions import HardBimodalDist as JHardBimodal
from manipose_tpu.toy.models import ACTIVATIONS as J_ACTIVATIONS
from manipose_tpu.toy.models import ConstrainedMlp as JConstrained
from manipose_tpu.toy.models import ConstrainedMlpRmcl as JConstrainedRmcl
from manipose_tpu.toy.models import ToyMlp as JToyMlp
from manipose_tpu_torch.toy import paper_figures
from manipose_tpu_torch.toy.distributions import HardBimodalDist
from manipose_tpu_torch.weights import toy_state_dict_from_jax

PNG = b"\x89PNG\r\n\x1a\n"
RUN_TOL, HYP_TOL = 1e-4, 5e-4
N_TRAIN, N_TEST, EPOCHS = 300, 40, 2


def _jax_inits(seed, n_train, n_test):
    """The initial variables ``manipose_tpu.toy.paper_figures.
    train_figure_models`` draws, as the port's state dicts."""
    data = JLiftingDataset(JHardBimodal(radius=1.0, random_state=seed), n_train, n_train,
                           n_test)
    act = J_ACTIVATIONS["tanh"]
    models = {"mlp": JToyMlp(32, 2, 2, act), "constrained": JConstrained(32, 2, act, 1.0),
              "constrained_rmcl": JConstrainedRmcl(32, 2, act, 1.0, n_hyp=2, beta=0.1)}
    out = {}
    for name, model in models.items():
        variables = model.init({"params": jax.random.PRNGKey(seed)}, data.x_train[:2],
                               train=False)
        out[name] = toy_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables))
    return out


def test_train_figure_models_matches_jax():
    want = j_figures.train_figure_models(JHardBimodal(radius=1.0, random_state=0), seed=0,
                                         epochs=EPOCHS, n_train=N_TRAIN, n_test=N_TEST)
    got = paper_figures.train_figure_models(
        HardBimodalDist(radius=1.0, random_state=0), seed=0, epochs=EPOCHS,
        n_train=N_TRAIN, n_test=N_TEST, device="cpu",
        state_dicts=_jax_inits(0, N_TRAIN, N_TEST))
    np.testing.assert_array_equal(got[0], want[0])  # the test inputs and targets
    np.testing.assert_array_equal(got[1], want[1])
    for name in ("mlp", "constrained", "constrained_rmcl"):
        g, w = got[2][name], np.asarray(want[2][name])
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=RUN_TOL * max(1.0, np.abs(w).max()),
                                   err_msg=name)
        np.testing.assert_allclose(got[4][name].loss_list, want[4][name].loss_list,
                                   rtol=RUN_TOL, err_msg=name)
    assert got[3]["mlp"] is None and want[3]["mlp"] is None
    h, w = got[3]["constrained_rmcl"], np.asarray(want[3]["constrained_rmcl"])
    assert h.shape == w.shape == (N_TEST, 2, 3)
    np.testing.assert_allclose(h, w, atol=HYP_TOL * max(1.0, np.abs(w).max()))


def test_figure8_is_the_jax_figure(tmp_path):
    got = paper_figures.figure8(tmp_path / "figure8.png", seed=123, n_samples=300)
    want = j_figures.figure8(tmp_path / "jax_figure8.png", seed=123, n_samples=300)
    assert got == str(tmp_path / "figure8.png")
    assert (tmp_path / "figure8.png").read_bytes() == (tmp_path / "jax_figure8.png").read_bytes()


def test_figure4_writes_its_png(tmp_path):
    path = tmp_path / "figure4.png"
    assert paper_figures.figure4(path, seed=0, epochs=1, n_train=200, n_test=20,
                                 device="cpu") == str(path)
    assert path.read_bytes()[:8] == PNG


def test_figures_need_matplotlib(monkeypatch):
    """Without matplotlib a figure raises its ImportError; the training
    does not need it."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="matplotlib"):
        paper_figures.figure8("unused.png", n_samples=10)
    out = paper_figures.train_figure_models(HardBimodalDist(radius=1.0, random_state=0),
                                            epochs=1, n_train=100, n_test=10,
                                            device="cpu")
    assert set(out[2]) == {"mlp", "constrained", "constrained_rmcl"}
