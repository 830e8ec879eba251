"""The port's models against the JAX package's, in f32 on the CPU, on
weights carried across with `params_from_jax`; and the weight loaders."""
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from nanosnp_tpu.config import HaplotypeModelConfig, PileupModelConfig
from nanosnp_tpu.models.bilstm import linear as jax_linear
from nanosnp_tpu.models.haplotype_model import \
    haplotype_forward as jax_haplotype_forward
from nanosnp_tpu.models.pileup_model import init_pileup_params, \
    pileup_forward as jax_pileup_forward
from nanosnp_tpu.train.train_pileup import load_params_npz as jax_load_npz
from nanosnp_tpu_torch.config import HaplotypeModelConfig as THapCfg
from nanosnp_tpu_torch.config import PileupModelConfig as TPileupCfg
from nanosnp_tpu_torch.models.bilstm import Dense
from nanosnp_tpu_torch.models.convert import (load_params_npz,
                                              load_pileup_checkpoint,
                                              params_from_jax,
                                              pileup_checkpoint_from_params,
                                              pileup_params_from_torch,
                                              save_params_npz)
from nanosnp_tpu_torch.models.haplotype_model import (HaplotypeModel,
                                                      haplotype_forward)
from nanosnp_tpu_torch.models.pileup_model import (PileupModel,
                                                   init_pileup_params as
                                                   torch_init_pileup_params,
                                                   pileup_forward)

V6B = os.path.join(os.path.dirname(os.path.dirname(__file__)), "nanosnp_tpu",
                   "models", "weights", "ont_haplotype_synthetic.npz")

# f32 on both sides; only the order of f32 sums differs (through 2-3
# BiLSTM layers and the head), a few ulps of the logits
LOGIT_TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_pileup_forward_all_heads_matches_jax_f32():
    cfg = PileupModelConfig()
    jparams = init_pileup_params(jax.random.key(3), cfg)
    x = np.random.default_rng(3).integers(-30, 30, (24, 33, 18)).astype(
        np.float32)
    want = jax_pileup_forward(jparams, jnp.asarray(x), cfg)
    model = PileupModel(TPileupCfg(), params_from_jax(_np_tree(jparams)))
    got = pileup_forward(model, torch.from_numpy(x))
    for g, w, n in zip(got, want, (21, 3, 33, 33)):
        assert tuple(g.shape) == (24, n)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def test_haplotype_forward_v6b_full_width_matches_jax_f32():
    """The shipped v6b weights at full width (H=256, 3 layers) on 32
    sites."""
    cfg = HaplotypeModelConfig()
    jparams = jax_load_npz(V6B)
    tparams = load_params_npz(V6B)
    enc = tparams["pileup_encoder"]
    assert len(enc) == 3 and tuple(enc[0]["w_hh"].shape) == (2, 256, 1024)
    rng = np.random.default_rng(4)
    xp = rng.uniform(0, 3, (32, 33, 105)).astype(np.float32)
    xh = rng.uniform(0, 3, (32, 11, 105)).astype(np.float32)
    want = jax_haplotype_forward(jparams, jnp.asarray(xp), jnp.asarray(xh),
                                 cfg)
    model = HaplotypeModel(THapCfg(), tparams)
    got = haplotype_forward(model, torch.from_numpy(xp), torch.from_numpy(xh))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def test_bf16_dense_matches_jax_linear():
    """bf16 operands with f32 accumulation: not a bf16-rounded product."""
    rng = np.random.default_rng(5)
    p = {"w": rng.standard_normal((64, 21)).astype(np.float32),
         "b": rng.standard_normal(21).astype(np.float32)}
    x = rng.standard_normal((10, 64)).astype(np.float32)
    want = np.asarray(jax_linear(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), jnp.bfloat16))
    got = Dense(params_from_jax(p))(torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.float32
    # the parameters are trainable: the product is part of autograd's graph
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4,
                               rtol=1e-5)


def test_npz_loader_matches_jax_loader():
    jtree = _np_tree(jax_load_npz(V6B))
    ttree = load_params_npz(V6B)
    jl, jdef = jax.tree.flatten(jtree)
    tl, tdef = jax.tree.flatten(ttree)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b.numpy())


def test_npz_round_trip(tmp_path):
    params = torch_init_pileup_params(torch.Generator().manual_seed(1),
                                      TPileupCfg(hidden_size=8))
    path = str(tmp_path / "p.npz")
    save_params_npz(path, params, dtype=np.float32)
    back = load_params_npz(path)
    for a, b in zip(jax.tree.leaves(_np_tree(params)),
                    jax.tree.leaves(_np_tree(back))):
        np.testing.assert_array_equal(a, b)


def test_pileup_checkpoint_round_trip(tmp_path):
    """params -> reference-layout checkpoint file -> params."""
    jparams = _np_tree(init_pileup_params(jax.random.key(6),
                                          PileupModelConfig()))
    path = str(tmp_path / "pileup.chkpt")
    torch.save(pileup_checkpoint_from_params(params_from_jax(jparams)), path)
    back = load_pileup_checkpoint(path)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(_np_tree(back))):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_converter_matches_jax_converter():
    from nanosnp_tpu.models.convert import \
        pileup_params_from_torch as jax_from_torch

    ck = pileup_checkpoint_from_params(torch_init_pileup_params(
        torch.Generator().manual_seed(2), TPileupCfg()))
    want = jax_from_torch(ck)
    got = _np_tree(pileup_params_from_torch(ck))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a, b)


def test_init_pileup_params_shapes_match_jax():
    want = jax.tree.map(np.shape, init_pileup_params(jax.random.key(0),
                                                     PileupModelConfig()))
    got = jax.tree.map(lambda t: tuple(t.shape), torch_init_pileup_params(
        torch.Generator().manual_seed(0), TPileupCfg()))
    assert got == want
