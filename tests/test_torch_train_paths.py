"""Two train steps of each path this slice added to the fusion layer,
against the JAX package's on CPU, as tests/test_torch_train.py holds the
attention path: JAX runs ``ops_impl="pallas"`` in interpret mode and the
port ``ops_impl="pallas"`` on CPU tensors (the kernels' plain versions),
both from the same flax weights.

- hideg: attention over a fully connected team of 130 robots in 256 node
  slots (in-degree 129 > 128, a row-expanded plan), so JAX runs
  expanded_attention_fused (_fused_parts_kernel, and _sddmm2, _spmm_t and
  _spmm in its vjp) and the port its ExpandedFusedAttention;
- mean and max: the small dynamic_swarm with ``model.fusion`` "mean" (JAX
  bsp_mean: _spmm_kernel, its vjp _spmm_t) and "max" (JAX ell_max:
  _max_kernel, its vjp in XLA).

Sizes: 16x16 images, encoder 16/32/64 (D 256), attention dim 64.
Tolerances as tests/test_torch_train.py: loss terms and grad norms 1e-5
relative, parameters 2e-5 absolute (the attention key bias, whose true
gradient is 0, 2 x the sum of the learning rates).

The hideg batch holds 130 views (and 126 padded slots). There one ReLU
gate of the encoder (in res1's first ConvBlock, at an input of 7e-7) falls
on the other side of 0 than in JAX, which moves the encoder's gradients by
up to 1.1e-3 of their largest element. So that path's first step runs
with JAX's gates forced into every encoder block
(``test_torch_edge.force_jax_gates``; the flipped gates are few, each
within 1e-5 of 0), and its gradients are held to 1e-5 of each tensor's
largest element. Adam turns noise on a near-zero gradient element into an
update of about lr, so that path's parameters after two steps are held to
2 x the sum of the learning rates.
"""

import dataclasses

import jax
import numpy as np
import pytest

from mrp_gnn_tpu import train as JT
from mrp_gnn_tpu.config import get_config as jax_config
from mrp_gnn_tpu.data.pipeline import make_dataset as jax_dataset
from mrp_gnn_tpu.losses import total_loss as jax_total_loss
from mrp_gnn_tpu_torch import train as TT
from mrp_gnn_tpu_torch.config import get_config
from mrp_gnn_tpu_torch.data.pipeline import make_dataset
from mrp_gnn_tpu_torch.models import MultiRobotPerceptionNet
from mrp_gnn_tpu_torch.models.transplant import load_flax_params
from mrp_gnn_tpu_torch.ops import bsp
from tests.test_torch_edge import assert_few_flips, force_jax_gates
from tests.test_torch_train import (ZERO_GRAD_PARAMS, _check_params,
                                    _check_terms, _np_params, _small,
                                    _torch_inputs)


def _path(cfg, path):
    cfg = _small(cfg)
    if path == "hideg":
        return cfg.replace(data=dataclasses.replace(
            cfg.data, num_robots=130, scenes_per_batch=1, connectivity="full",
            comm_radius=0, mobility=0.0, max_nodes=256, num_train_scenes=2))
    return cfg.replace(model=dataclasses.replace(cfg.model, fusion=path))


def _jax_grads(jcfg, jmodel, params, b):
    """jax.grad of the JAX train step's loss on batch ``b``."""
    tr = jcfg.train

    def loss(p):
        out = jmodel.apply(p, b["images"], b["graph"])
        return jax_total_loss(out, {"depth": b["depth"], "seg": b["seg"]},
                              b["graph"].node_mask, tr.depth_loss_weight,
                              tr.seg_loss_weight, depth_loss=tr.depth_loss)[0]

    return jax.tree.map(np.asarray, jax.grad(loss)(params))


def _check_grads(names, grads, jax_grads, tcfg):
    ref = dict(load_flax_params(MultiRobotPerceptionNet(tcfg.model),
                                jax_grads).named_parameters())
    for name, g in zip(names, grads):
        if name in ZERO_GRAD_PARAMS:
            continue
        want = ref[name].detach().numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("path", ["hideg", "mean", "max"])
def test_two_train_steps_match_jax_pallas(path):
    jcfg = _path(jax_config("dynamic_swarm"), path)
    tcfg = _path(get_config("dynamic_swarm"), path)
    jb = [b for _, b in zip(range(2), jax_dataset(jcfg.data, "train"))]
    tb = [b for _, b in zip(range(2), make_dataset(tcfg.data, "train"))]
    g = tb[0]["graph"]
    assert (bsp.supports_expanded(g) if path == "hideg" else bsp.supports(g))
    state, jmodel = JT.create_train_state(jcfg, jax.random.PRNGKey(0), jb[0])
    model = load_flax_params(MultiRobotPerceptionNet(tcfg.model,
                                                     ops_impl="pallas"),
                             _np_params(state))
    jstep = JT.make_train_step(jcfg, jmodel, JT.make_optimizer(jcfg),
                               donate=False)
    opt = TT.make_optimizer(tcfg, model.parameters())
    seen = []
    update = opt.step
    opt.step = lambda grads: seen.append(grads) or update(grads)
    tstate = TT.TrainState(model, opt)
    tstep = TT.make_train_step(tcfg, model, opt)
    handles, gates = [], {}
    jax_grads = None
    if path == "hideg":  # JAX's gates in every encoder block, first step
        jax_grads = _jax_grads(jcfg, jmodel, state.params, jb[0])
        _, inter = jmodel.apply(state.params, jb[0]["images"], jb[0]["graph"],
                                capture_intermediates=True,
                                mutable=["intermediates"])
        enc = inter["intermediates"]["encoder"]
        handles, gates = force_jax_gates(
            enc, model.encoder, [n for n in enc if n != "__call__"])
    bsp.reset_launches()
    for i, (a, b) in enumerate(zip(jb, tb)):
        state, jterms = jstep(state, a["images"], a["depth"], a["seg"],
                              a["graph"])
        tstate, terms = tstep(tstate, *_torch_inputs(b))
        for h in handles:
            h.remove()
        handles = []
        _check_terms(terms, jax.device_get(jterms), i)
    assert set(bsp.launch_counts().values()) == {0}  # CPU: plain versions
    lr_sum = sum(TT.warmup_cosine_lr(tcfg, c) for c in range(2))
    if path != "hideg":
        _check_params(model, _np_params(state), tcfg, lr_sum)
        return
    assert_few_flips(gates)
    _check_grads([n for n, _ in model.named_parameters()], seen[0],
                 jax_grads, tcfg)
    ref = dict(load_flax_params(MultiRobotPerceptionNet(tcfg.model),
                                _np_params(state)).named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[name].detach().numpy(), rtol=0,
                                   atol=2 * lr_sum, err_msg=name)
