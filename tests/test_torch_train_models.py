"""The port's training forward (models' forward_train) against the JAX
package's training branch: gradients of the train loss of both models, on
the kernel path (the training kernels' plain versions, bf16 w_hh) against
`use_pallas=True, pallas_interpret=True` (pileup), and on the f32 path
against `use_pallas=False` (both). Small configurations; dropout 0.0 with
a dropout rng given, which forces the training branch on the JAX side (as
the JAX package's own test_pallas_train_step_grads_full_model does)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nanosnp_tpu.config import HaplotypeModelConfig as JHapCfg
from nanosnp_tpu.config import PileupModelConfig as JPileCfg
from nanosnp_tpu.models.haplotype_model import (
    haplotype_forward as jax_haplotype_forward,
    init_haplotype_params as jax_init_haplotype)
from nanosnp_tpu.models.pileup_model import (
    init_pileup_params as jax_init_pileup, pileup_forward as jax_pileup_forward)
from nanosnp_tpu.train.losses import label_smoothing_loss as jax_ls_loss
from nanosnp_tpu_torch.config import HaplotypeModelConfig, PileupModelConfig
from nanosnp_tpu_torch.models.bilstm import dropout_between_layers
from nanosnp_tpu_torch.models.convert import flatten_tree, params_from_jax
from nanosnp_tpu_torch.models.haplotype_model import HaplotypeModel
from nanosnp_tpu_torch.models.pileup_model import PileupModel
from nanosnp_tpu_torch.train.losses import label_smoothing_loss

# f32 path: same f32 math on both sides, summation order only
F32_ATOL, F32_RTOL = 2e-5, 1e-4
# kernel path: the same bf16 cast sites on both sides; a reordered f32 sum
# can flip the bf16 rounding of an h_{t-1} or a dgate (2^-8 relative) and
# carry it into the gradients, and dW_hh is rounded to bf16 (2^-8 relative)
BF16_ATOL, BF16_RTOL = 2e-4, 1e-2

# a short window keeps the Pallas interpret mode quick
PILE = dict(hidden_size=8, output_size=16, inner_size=16, n_layers=2,
            dropout=0.0, seq_len=9)
HAP = dict(hidden_size=8, lstm_layers=2, dropout=0.0, pileup_length=9,
           haplotype_length=5, pileup_dim=12, haplotype_dim=12)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf_dict(tree):
    return {path: np.asarray(v) for path, v in flatten_tree(tree)}


def _compare(got, want_tree, use_kernels):
    """got {path: grad} against the JAX gradient tree."""
    atol, rtol = (BF16_ATOL, BF16_RTOL) if use_kernels else (F32_ATOL,
                                                             F32_RTOL)
    want = _leaf_dict(want_tree)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=atol,
                                   rtol=rtol, err_msg=str(path))


def _pileup_grads(use_pallas):
    rng = np.random.default_rng(8)
    cfg = JPileCfg(**PILE)
    params = _np_tree(jax_init_pileup(jax.random.key(9), cfg))
    x = rng.standard_normal((11, 9, 18)).astype(np.float32)
    gt_t = rng.integers(0, 21, 11)
    zy_t = rng.integers(0, 3, 11)

    def loss(p):
        gt, zy, _, _ = jax_pileup_forward(p, jnp.asarray(x), cfg,
                                          all_heads=False,
                                          dropout_rng=jax.random.key(4),
                                          use_pallas=use_pallas,
                                          pallas_interpret=True)
        return (jax_ls_loss(gt, jnp.asarray(gt_t), 0.1)
                + jax_ls_loss(zy, jnp.asarray(zy_t), 0.1))

    want = _np_tree(jax.grad(loss)(jax.tree.map(jnp.asarray, params)))
    model = PileupModel(PileupModelConfig(**PILE), params_from_jax(params))
    gt, zy = model.forward_train(torch.from_numpy(x), use_kernels=use_pallas,
                                 generator=torch.Generator().manual_seed(4))
    loss_t = (label_smoothing_loss(gt, torch.from_numpy(gt_t), 0.1)
              + label_smoothing_loss(zy, torch.from_numpy(zy_t), 0.1))
    tree = model.tree()
    leaves = [p for _, p in flatten_tree(tree)]
    grads = torch.autograd.grad(loss_t, leaves, allow_unused=True,
                                materialize_grads=True)
    return {path: g.numpy() for (path, _), g in
            zip(flatten_tree(tree), grads)}, want


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernel-path", "f32-path"])
def test_pileup_grads_match_jax(use_kernels):
    got, want = _pileup_grads(use_kernels)
    _compare(got, want, use_kernels)
    # the recurrent weights reach the loss: their gradient is not zero
    assert np.abs(got[("encoder", 0, "w_hh")]).max() > 1e-4


def _hap_inputs(rng, n):
    xp = rng.standard_normal((n, 9, 12)).astype(np.float32)
    xh = rng.standard_normal((n, 5, 12)).astype(np.float32)
    return xp, xh, rng.integers(0, 10, n), rng.integers(0, 3, n)


# The haplotype kernel path runs the same layers as the pileup one (checked
# above) in two branches; in interpret mode it would double that test's
# time, so the haplotype wiring is held to JAX on the f32 path.
@pytest.mark.parametrize("use_kernels", [False], ids=["f32-path"])
def test_haplotype_grads_match_jax(use_kernels):
    rng = np.random.default_rng(11)
    cfg = JHapCfg(**HAP)
    params = _np_tree(jax_init_haplotype(jax.random.key(3), cfg))
    xp, xh, gt_t, zy_t = _hap_inputs(rng, 10)

    def loss(p):
        gt, zy = jax_haplotype_forward(p, jnp.asarray(xp), jnp.asarray(xh),
                                       cfg, dropout_rng=jax.random.key(1),
                                       use_pallas=use_kernels,
                                       pallas_interpret=True)
        return (jax_ls_loss(gt, jnp.asarray(gt_t), 0.1)
                + jax_ls_loss(zy, jnp.asarray(zy_t), 0.1))

    want = _np_tree(jax.grad(loss)(jax.tree.map(jnp.asarray, params)))
    model = HaplotypeModel(HaplotypeModelConfig(**HAP),
                           params_from_jax(params))
    gt, zy = model.forward_train(torch.from_numpy(xp), torch.from_numpy(xh),
                                 use_kernels=use_kernels,
                                 generator=torch.Generator().manual_seed(1))
    loss_t = (label_smoothing_loss(gt, torch.from_numpy(gt_t), 0.1)
              + label_smoothing_loss(zy, torch.from_numpy(zy_t), 0.1))
    flat = flatten_tree(model.tree())
    grads = torch.autograd.grad(loss_t, [p for _, p in flat])
    _compare({path: g.numpy() for (path, _), g in zip(flat, grads)}, want,
             use_kernels)


def test_dropout_statistics():
    """Inverted dropout: about p of the values are zeroed, survivors are
    scaled by 1/keep; no generator (inference) or p = 0 is the identity."""
    x = torch.rand(200, 33, 16) + 0.5
    p = 0.3
    out = dropout_between_layers(x, p, torch.Generator().manual_seed(0))
    zero = out == 0
    assert abs(zero.float().mean().item() - p) < 0.01   # 105,600 draws
    torch.testing.assert_close(out[~zero], x[~zero] / (1 - p))
    assert dropout_between_layers(x, p, None) is x
    assert dropout_between_layers(x, 0.0, torch.Generator()) is x


def test_dropout_is_off_without_a_generator():
    """forward_train without a generator (validation) equals the model at
    dropout 0, and a generator does change the output at dropout > 0."""
    rng = np.random.default_rng(5)
    cfg = PileupModelConfig(**{**PILE, "dropout": 0.5})
    params = params_from_jax(_np_tree(jax_init_pileup(jax.random.key(2),
                                                      JPileCfg(**PILE))))
    x = torch.from_numpy(rng.standard_normal((7, 9, 18)).astype(np.float32))
    with torch.no_grad():
        a = PileupModel(cfg, params).forward_train(x, use_kernels=False)
        b = PileupModel(PileupModelConfig(**PILE), params).forward_train(
            x, use_kernels=False)
        c = PileupModel(cfg, params).forward_train(
            x, use_kernels=False, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a[0], b[0], atol=0, rtol=0)
    assert not torch.equal(a[0], c[0])


def test_trainable_params_do_not_change_inference():
    """Parameters are trainable now; inference under inference_mode still
    gives the kernel path's probabilities and records no graph."""
    cfg = PileupModelConfig(**PILE)
    params = params_from_jax(_np_tree(jax_init_pileup(jax.random.key(6),
                                                      JPileCfg(**PILE))))
    model = PileupModel(cfg, params)
    assert all(p.requires_grad for p in model.parameters())
    x = torch.randn(5, 9, 18)
    with torch.inference_mode():
        gt, zy, _, _ = model(x, compute_dtype=torch.bfloat16,
                             all_heads=False)
    assert not gt.requires_grad and gt.shape == (5, 21)
