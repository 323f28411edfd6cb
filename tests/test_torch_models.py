"""Per-layer activations of the port's model against the JAX model, with
the flax parameters moved across by load_flax_params.

Small size: 16x16 images, encoder channels (8, 16). Tolerance 1e-4: the
convolutions sum in another order in XLA and in torch (f32).
"""

import jax
import numpy as np
import pytest
import torch

from mrp_gnn_tpu import graph as jg
from mrp_gnn_tpu.config import ModelConfig as JModelConfig
from mrp_gnn_tpu.models.decoder import Decoder as JDecoder
from mrp_gnn_tpu.models.decoder import DepthHead as JDepthHead
from mrp_gnn_tpu.models.decoder import SegHead as JSegHead
from mrp_gnn_tpu.models.encoder import Encoder as JEncoder
from mrp_gnn_tpu.models.fusion import GraphFusionLayer as JFusion
from mrp_gnn_tpu.models.net import MultiRobotPerceptionNet as JNet
from mrp_gnn_tpu_torch import graph as tg
from mrp_gnn_tpu_torch.config import ModelConfig as TModelConfig
from mrp_gnn_tpu_torch.models.decoder import Decoder, DepthHead, SegHead
from mrp_gnn_tpu_torch.models.encoder import Encoder
from mrp_gnn_tpu_torch.models.fusion import GraphFusionLayer
from mrp_gnn_tpu_torch.models.net import MultiRobotPerceptionNet
from mrp_gnn_tpu_torch.models.transplant import load_flax_params

TOL = dict(rtol=1e-4, atol=1e-4)
CH = (8, 16)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _close_nchw(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **tol)


def _graphs(kind):
    """"ell": dynamic-style graph with a tile-pair plan (scene_stride 0),
    padded nodes; "block": block-diagonal batch with a padded scene."""
    if kind == "ell":
        rng = np.random.default_rng(0)
        pos = [np.arange(6) + rng.uniform(-1.5, 1.5, 6) for _ in range(2)]
        caps = dict(max_nodes=16, max_edges=60, max_degree=5)
        return (jg.batch_from_positions(pos, 2.0, backend="numpy", **caps),
                tg.batch_from_positions(pos, 2.0, **caps))
    e = jg.radius_edges(4, 1)
    return (jg.batch_homogeneous(3, 4, e, max_nodes=16),
            tg.batch_homogeneous(3, 4, e, max_nodes=16))


def test_encoder_matches_jax():
    x = np.random.default_rng(1).uniform(size=(4, 16, 16, 3)).astype(np.float32)
    jm = JEncoder(CH)
    params = jm.init(jax.random.PRNGKey(0), x)
    (jskips, jout) = jm.apply(params, x)
    tm = load_flax_params(Encoder(CH), _np_tree(params))
    skips, out = tm(_nchw(x))
    for a, b in zip(skips, jskips):
        _close_nchw(a, b)
    _close_nchw(out, jout)


@pytest.mark.parametrize("agg,heads,kind", [
    ("attention", 1, "ell"), ("attention", 1, "block"),
    ("attention", 2, "ell"), ("mean", 1, "ell"), ("mean", 1, "block"),
    ("max", 1, "ell")])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_fusion_layer_matches_jax(agg, heads, kind, impl):
    jgb, tgb = _graphs(kind)
    V, C = jgb.max_nodes, CH[-1]
    feats = np.random.default_rng(2).normal(size=(V, 4, 4, C)).astype(np.float32)
    jm = JFusion(aggregation=agg, attention_dim=8, attention_heads=heads,
                 ops_impl=impl)
    params = jm.init(jax.random.PRNGKey(3), feats, jgb)
    want = jm.apply(params, feats, jgb)
    tm = load_flax_params(
        GraphFusionLayer(C, aggregation=agg, attention_dim=8,
                         attention_heads=heads, ops_impl=impl),
        _np_tree(params))
    with torch.no_grad():
        got = tm(_nchw(feats), tgb)
    _close_nchw(got, want)


def test_decoder_and_heads_match_jax():
    rng = np.random.default_rng(4)
    skips = [rng.normal(size=(3, 8, 8, 8)).astype(np.float32),
             rng.normal(size=(3, 4, 4, 16)).astype(np.float32)]
    jd = JDecoder(CH)
    pd = jd.init(jax.random.PRNGKey(5), skips, skips[-1])
    jdec = jd.apply(pd, skips, skips[-1])
    td = load_flax_params(Decoder(CH), _np_tree(pd))
    dec = td([_nchw(s) for s in skips], _nchw(skips[-1]))
    _close_nchw(dec, jdec)

    jh = JDepthHead(0.1, 20.0)
    ph = jh.init(jax.random.PRNGKey(6), jdec)
    th = load_flax_params(DepthHead(CH[0], 0.1, 20.0), _np_tree(ph))
    np.testing.assert_allclose(th(_nchw(np.asarray(jdec))).detach().numpy(),
                               np.asarray(jh.apply(ph, jdec)), **TOL)
    js = JSegHead(6)
    ps = js.init(jax.random.PRNGKey(7), jdec)
    ts = load_flax_params(SegHead(CH[0], 6), _np_tree(ps))
    _close_nchw(ts(_nchw(np.asarray(jdec))), js.apply(ps, jdec))


def _net_pair(kind, impl, **model):
    jgb, tgb = _graphs(kind)
    kw = dict(image_size=(16, 16), encoder_channels=CH, attention_dim=8,
              num_seg_classes=6, **model)
    jcfg, tcfg = JModelConfig(**kw), TModelConfig(**kw)
    images = np.random.default_rng(8).uniform(
        size=(jgb.max_nodes, 16, 16, 3)).astype(np.float32)
    jm = JNet(jcfg, ops_impl=impl)
    params = jm.init(jax.random.PRNGKey(9), images, jgb)
    tm = load_flax_params(MultiRobotPerceptionNet(tcfg, ops_impl=impl),
                          _np_tree(params))
    return jm, params, tm, images, jgb, tgb


@pytest.mark.parametrize("kind,impl", [("ell", "pallas"), ("ell", "xla"),
                                       ("block", "auto")])
def test_whole_net_matches_jax(kind, impl):
    jm, params, tm, images, jgb, tgb = _net_pair(kind, impl)
    want = jm.apply(params, images, jgb)
    with torch.no_grad():
        got = tm(torch.from_numpy(images), tgb)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


def test_whole_net_bf16_matches_jax():
    """bfloat16 compute with float32 parameters. Tolerance rtol 3e-2, about
    four bf16 ulps (2^-7 relative each): the depth itself is computed in
    bf16, and the two frameworks round at different places (conv
    accumulation, GroupNorm output)."""
    jm, params, tm, images, jgb, tgb = _net_pair("ell", "xla", dtype="bfloat16")
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    want = jm.apply(params, images, jgb)
    with torch.no_grad():
        got = tm(torch.from_numpy(images), tgb)
    assert got["depth"].dtype == torch.float32
    assert got["fused"].dtype == torch.bfloat16
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]),
                               rtol=3e-2, atol=0)


def test_seeded_init_is_deterministic_and_flax_like():
    cfg = TModelConfig(image_size=(16, 16), encoder_channels=CH,
                       num_seg_classes=6)
    a = MultiRobotPerceptionNet(cfg, generator=torch.Generator().manual_seed(0))
    b = MultiRobotPerceptionNet(cfg, generator=torch.Generator().manual_seed(0))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    w = a.encoder.res1.Conv_0.weight          # fan_in 16 * 3 * 3
    std = (1.0 / 144) ** 0.5
    assert float(w.detach().abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert torch.equal(a.fusion0.value.bias, torch.zeros(16))
    assert torch.equal(a.fusion0.update_norm.weight, torch.ones(16))


def test_transplant_rejects_unmatched_names():
    jm, params, tm, *_ = _net_pair("ell", "xla")
    tree = _np_tree(params)["params"]
    extra = dict(tree, bogus={"kernel": np.zeros((1, 1), np.float32)})
    with pytest.raises(KeyError, match="bogus"):
        load_flax_params(tm, extra)
    missing = {k: v for k, v in tree.items() if k != "seg_head"}
    with pytest.raises(KeyError, match="seg_head"):
        load_flax_params(tm, missing)
    bad = dict(tree, depth_head={"out": {
        "kernel": np.zeros((1, 1, 3, 1), np.float32),
        "bias": np.zeros(1, np.float32)}})
    with pytest.raises(ValueError, match="depth_head"):
        load_flax_params(tm, bad)
