"""Port parity: the paper's five Table-4 nets (``models.evalzoo``).

Each net is built at a small width in both packages; the reference's
random parameters go through ``models.convert.evalzoo_params_from_jax``
into the port, and then:

  * the loss agrees within rtol 1e-4 (fp32) and the gradient of every
    parameter within rtol 1e-3 plus atol 1e-3 of the net's largest
    gradient: fp32 sums run in other orders, and batch norm over a few
    values (ResNet's last stage: 8 per channel) amplifies that noise; the
    Transformer's all-equal tokens make its q/k gradients rounding noise
    around zero, which only a net-wide scale judges;
  * the tracked forward pass and training iteration agree per
    kernel-varying kind as in ``test_torch_tracker``: op counts exactly,
    FLOPs to rel 1e-9 (the iteration's ``recurrent`` FLOPs in the band
    stated there), forward-op params exactly, and in the iteration every
    conv2d's params.

Exempt, by name and reason:
  * ``resnet50`` and ``inception_v3``: the stem convolution and its grad
    weight.  JAX's "SAME" pads these stems unevenly ((2, 3) for the 7x7/2
    on an even image, (0, 1) for the 3x3/2), which ``torch.conv2d``
    cannot, so the port pads the input with ``F.pad`` and runs an
    unpadded convolution: it records the padded image (37 and 33 here)
    and padding 0 where the reference records 32 and the leading pad.
    Their FLOPs are equal and stay in the comparison.
  * ``transformer``: the reference's decoder scans its layer stack with
    ``lax.scan``, which its tracker folds into one ``recurrent`` op; the
    port loops over its layers as the paper's PyTorch nets do.  So the
    reference's layer scan is unrolled here (its body walked with
    multiplicity ``n_layers``, as the reference walks a scan without a
    matmul) before comparing.
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.trace as ref_trace
from repro.core.trace import OperationTracker as RefTracker
from repro.models import evalzoo as ref_evalzoo
from repro_torch.core import OperationTracker
from repro_torch.models import evalzoo
from repro_torch.models.convert import evalzoo_params_from_jax
from test_torch_tracker import assert_parity, kv_params

LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-3, 1e-3


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the small widths, shared with chip_smoke's check that the card's op
#: list equals the CPU's
SMALL = _chip_smoke().TRACK_SMALL

#: (kind, params) of the exempt stem ops, per net (see the docstring)
STEM_EXEMPT = {
    "resnet50": [("conv2d", dict(batch=2, image=37, in_ch=3, kernel=7,
                                 out_ch=8, padding=0, stride=2)),
                 ("conv2d", dict(batch=3, image=37, in_ch=2, kernel=16,
                                 out_ch=8, padding=0, stride=1))],
    "inception_v3": [("conv2d", dict(batch=2, image=33, in_ch=3, kernel=3,
                                     out_ch=8, padding=0, stride=2)),
                     ("conv2d", dict(batch=3, image=33, in_ch=2, kernel=16,
                                     out_ch=8, padding=0, stride=1))],
}
REF_STEM = {
    "resnet50": [("conv2d", dict(batch=2, image=32, in_ch=3, kernel=7,
                                 out_ch=8, padding=2, stride=2)),
                 ("conv2d", dict(batch=3, image=32, in_ch=2, kernel=16,
                                 out_ch=8, padding=2, stride=1))],
    "inception_v3": [("conv2d", dict(batch=2, image=32, in_ch=3, kernel=3,
                                     out_ch=8, padding=0, stride=2)),
                     ("conv2d", dict(batch=3, image=32, in_ch=2, kernel=16,
                                     out_ch=8, padding=0, stride=1))],
}


def _key(kind, params):
    return kind, tuple(sorted(params.items()))


class Net:
    """One net built in both packages, tracked forward and as an
    iteration, computed once per module."""

    def __init__(self, name):
        kw = SMALL[name]
        self.name = name
        r_it, r_params, r_batch = ref_evalzoo.make_train_iteration(name, **kw)
        r_step, _, _ = ref_evalzoo.make_train_iteration(name, grad=False,
                                                        **kw)
        self.ref_loss, ref_grads = jax.jit(jax.value_and_grad(r_step))(
            r_params, r_batch)
        np_params = jax.tree.map(np.asarray, r_params)
        cfg = (evalzoo.transformer_config(kw["d_model"], kw["n_layers"],
                                          kw["vocab"])
               if name == "transformer" else None)
        it, _, batch = evalzoo.make_train_iteration(name, device="cpu", **kw)
        step, _, _ = evalzoo.make_train_iteration(name, grad=False,
                                                  device="cpu", **kw)
        params = evalzoo_params_from_jax(name, np_params, cfg, device="cpu")
        loss = step(params, batch)
        grads = torch.autograd.grad(loss, evalzoo.leaves(params))
        self.loss = float(loss.detach())
        self.grads = [g.numpy() for g in grads]
        if name == "transformer":
            # the port's leaves: embed, final_norm, lm_head, then each
            # layer's tensors; the reference stacks layers by name
            g = jax.tree.map(np.asarray, ref_grads)
            self.ref_grads = [g["embed"], g["final_norm"], g["lm_head"]] + [
                g["layers"][k][i] for i in range(kw["n_layers"])
                for k in params.layers[i].keys()]
        else:
            self.ref_grads = _ref_leaves(jax.tree.map(np.asarray, ref_grads),
                                         np_params)
        orig = ref_trace._scan_is_recurrent
        if name == "transformer":     # unroll the layer scan (docstring)
            ref_trace._scan_is_recurrent = lambda jaxpr: False
        try:
            self.ref_fwd = RefTracker().track(r_step, r_params, r_batch)
            self.ref_it = RefTracker().track(r_it, r_params, r_batch)
        finally:
            ref_trace._scan_is_recurrent = orig
        self.fwd = OperationTracker().track(step, params, batch)
        self.it = OperationTracker().track(it, params, batch)


def _ref_leaves(grads, like):
    """The reference's gradient tree in the port's leaf order (the
    insertion order of the reference's own dicts)."""
    if isinstance(like, dict):
        return [x for k in like for x in _ref_leaves(grads[k], like[k])]
    return [grads]


_NETS = {}


def _net(name) -> Net:
    if name not in _NETS:
        _NETS[name] = Net(name)
    return _NETS[name]


@pytest.fixture(params=sorted(SMALL))
def net(request):
    return _net(request.param)


def test_loss_agrees(net):
    assert math.isclose(net.loss, float(net.ref_loss), rel_tol=LOSS_RTOL)


def test_gradients_agree(net):
    assert len(net.grads) == len(net.ref_grads)
    atol = GRAD_ATOL_SHARE * max(float(np.abs(g).max())
                                 for g in net.ref_grads)
    for got, want in zip(net.grads, net.ref_grads):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol)


def test_forward_parity(net):
    assert_parity(net.ref_fwd, net.fwd, grad=False,
                  exempt=_exempt(net.name, 1), where=f"{net.name}/fwd")


def test_iteration_parity(net):
    assert_parity(net.ref_it, net.it, grad=True,
                  exempt=_exempt(net.name, 2), where=f"{net.name}/iteration")


def _exempt(name, n):
    """The stem ops of ``name``, both packages' records (the forward
    conv, and in an iteration its grad weight too)."""
    return [(k, _key(k, p)) for k, p in
            STEM_EXEMPT.get(name, [])[:n] + REF_STEM.get(name, [])[:n]]


@pytest.mark.parametrize("name", sorted(STEM_EXEMPT))
def test_exempt_stems_are_what_the_docstring_says(name):
    """The exemption covers exactly the stem: each exempt record occurs
    once, and its FLOPs equal the reference's record's."""
    net = _net(name)
    for (kind, p), (_, rp) in zip(STEM_EXEMPT[net.name],
                                  REF_STEM[net.name]):
        port = [op for op in net.it.ops if op.kind == kind
                and op.params == p]
        ref = [op for op in net.ref_it.ops if op.kind == kind
               and op.params == rp]
        assert len(port) == 1 and len(ref) == 1
        assert port[0].cost.flops == ref[0].cost.flops


def test_recurrent_regions_are_gnmt_layers():
    """GNMT: one recurrent op per LSTM layer forward and one backward,
    with the reference's forward params."""
    net = _net("gnmt")
    layers, hidden, seq, batch = 2, 16, 5, 2
    fwd = [op for op in net.fwd.ops if op.kind == "recurrent"]
    assert len(fwd) == 2 * layers
    assert all(op.params == {"batch": batch, "in_f": 2 * hidden,
                             "hidden": 4 * hidden, "seq": seq, "layers": 1,
                             "bidir": 0, "bias": 0} for op in fwd)
    assert len([op for op in net.it.ops
                if op.kind == "recurrent"]) == 4 * layers
    assert kv_params(net.fwd, {"recurrent"}) == \
        kv_params(net.ref_fwd, {"recurrent"})


def test_wallclock_replays_every_covered_op(net):
    """Every op of the iteration within the reference's coverage replays
    its recorded aten calls (none falls back to the simulator), and the
    ops outside it build nothing."""
    from repro_torch.core import calibration
    rand = calibration.RandomInputs(torch.device("cpu"))
    covered = 0
    for op in net.it.ops:
        built = calibration.build_callable(op, rand)
        assert (built is not None) == calibration.covers(op), op.name
        assert op.calls, op.name
        if built is not None:
            fn, args = built
            fn(*args)
            covered += 1
    assert covered > 0


# ---------------------------------------------------------------------------
# the convolution helpers against JAX, numerically
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,s", [(4, 2), (5, 1), (2, 2), (3, 1), (6, 2)])
def test_conv_transpose_matches_jax_same(k, s):
    """``_conv_t``'s padding and output padding reproduce JAX's
    ``conv_transpose(..., "SAME", transpose_kernel=True)`` (not assumed:
    derived, then checked here)."""
    rng = np.random.default_rng(k * 10 + s)
    x = rng.standard_normal((2, 6, 5, 5)).astype(np.float32)
    w = rng.standard_normal((6, 3, k, k)).astype(np.float32)
    want = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"), transpose_kernel=True))
    got = evalzoo._conv_t(torch.from_numpy(x), torch.from_numpy(w), s)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_dcgan_transpose_padding_is_one_and_zero():
    assert evalzoo._conv_transpose_padding(4, 2) == (1, 0)
    # JAX pads the 3x3/2 case more before than after, which torch's
    # output padding cannot express: refused, not cropped silently
    with pytest.raises(ValueError, match="output_padding"):
        evalzoo._conv_transpose_padding(3, 2)


@pytest.mark.parametrize("size,k,s", [(32, 7, 2), (32, 3, 2), (33, 3, 2),
                                      (16, 1, 2), (16, 3, 1), (9, 5, 1)])
def test_same_conv_matches_jax(size, k, s):
    rng = np.random.default_rng(size + k + s)
    x = rng.standard_normal((2, 3, size, size)).astype(np.float32)
    w = rng.standard_normal((4, 3, k, k)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW")))
    got = evalzoo._conv(torch.from_numpy(x), torch.from_numpy(w), s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_iteration_applies_sgd():
    """The iteration returns the loss and ``p - 1e-3 * g``."""
    it, params, batch = evalzoo.make_train_iteration(
        "dcgan", device="cpu", **SMALL["dcgan"])
    step, _, _ = evalzoo.make_train_iteration(
        "dcgan", grad=False, device="cpu", **SMALL["dcgan"])
    loss, new = it(params, batch)
    flat = evalzoo.leaves(params)
    grads = torch.autograd.grad(step(params, batch), flat)
    for p, g, n in zip(flat, grads, evalzoo.leaves(new)):
        torch.testing.assert_close(n, p.detach() - 1e-3 * g)
    assert torch.isfinite(loss)
    assert sorted(new) == sorted(params)
