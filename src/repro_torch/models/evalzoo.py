"""The paper's evaluation networks (Table 4), the port of
``repro.models.evalzoo``.

ResNet-50, the Inception-style net, DCGAN, GNMT and the Transformer,
with the reference's architectures, parameter names and default sizes,
random initialisation from a seeded ``torch.Generator`` on the target
device (the reference's distributions, not its numbers; nothing is
downloaded).  Each ``make_*`` returns ``(step, params, batch)`` where
``step(params, batch)`` is the scalar loss, and
:func:`make_train_iteration` wraps it into the paper's unit: forward,
backward and the SGD update ``p - 1e-3·g`` (Sec. 2.1), the callable the
tracker wraps (Listing 1's ``run_my_training_iteration``).

Where JAX's ``"SAME"`` padding is uneven (ResNet's 7x7/2 stem on an even
image pads (2, 3), the Inception stem's 3x3/2 pads (0, 1)), the input is
padded by ``F.pad`` ahead of an unpadded convolution, since
``torch.conv2d`` pads symmetrically: the function is the reference's,
but the tracked stem records the padded image and padding 0 where the
reference records the image and its leading pad.  DCGAN's transposed
convolutions (JAX's ``conv_transpose(..., "SAME",
transpose_kernel=True)``) are ``conv_transpose2d`` with the padding and
output padding :func:`_conv_transpose_padding` derives (1 and 0 for the
4x4/2 layers).  GNMT's LSTM cells (gate order i, f, g, o; forget bias +1)
run through :func:`repro_torch.core.trace.recurrent_scan`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.devices import torch_device
from repro_torch.core.trace import recurrent_scan
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_dense

_F32 = torch.float32


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """JAX's ``"SAME"`` (lo, hi) padding of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """``"SAME"``-padded NCHW/OIHW convolution."""
    ph = _same_pads(x.shape[2], w.shape[2], stride)
    pw = _same_pads(x.shape[3], w.shape[3], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def _conv_transpose_padding(k: int, s: int) -> Tuple[int, int]:
    """(padding, output_padding) of ``conv_transpose2d`` that computes
    JAX's ``conv_transpose(..., "SAME")`` with a k-wide kernel and stride
    s: JAX pads the dilated input by (a, b), which is torch's
    ``k - 1 - padding`` before and that plus ``output_padding`` after."""
    pad_len = k + s - 2
    a = k - 1 if s > k - 1 else -(-pad_len // 2)
    padding, output_padding = k - 1 - a, (pad_len - a) - a
    if not 0 <= output_padding < s:
        raise ValueError(
            f"JAX's SAME transpose padding ({a}, {pad_len - a}) of a "
            f"{k}-wide kernel at stride {s} needs output_padding "
            f"{output_padding}, which conv_transpose2d cannot express")
    return padding, output_padding


def _conv_t(x, w, stride=2):
    """Transposed conv (DCGAN generator upsampling); ``w`` is the OIHW
    kernel of the convolution it transposes, as in the reference."""
    p, op = _conv_transpose_padding(w.shape[2], stride)
    return F.conv_transpose2d(x, w, stride=stride, padding=p,
                              output_padding=op)


def _bn(x, scale, bias):
    mean = x.mean((0, 2, 3), keepdim=True)
    var = x.var((0, 2, 3), keepdim=True, correction=0)
    xn = (x - mean) * torch.rsqrt(var + 1e-5)
    return xn * scale[None, :, None, None] + bias[None, :, None, None]


def _softmax_ce(logits, labels):
    # one-hot as JAX's ``one_hot`` builds it, a comparison with an iota:
    # ``F.one_hot`` checks its labels' range on the CPU alone (two
    # reductions and two host reads), which would part the CPU's op list
    # from the card's
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels[..., None].to(torch.long) == classes).to(_F32)
    return -torch.mean(torch.sum(torch.log_softmax(logits, -1) * onehot, -1))


def _w(gen, shape, scale=None):
    return init_dense(shape, _F32, gen, scale)


def _ones(gen, n):
    return torch.ones((n,), dtype=_F32, device=gen.device)


def _zeros(gen, n):
    return torch.zeros((n,), dtype=_F32, device=gen.device)


# ---------------------------------------------------------------------------
# ResNet (bottleneck blocks; depth 50 at scale=1)
# ---------------------------------------------------------------------------
def make_resnet(gen: torch.Generator, batch: int = 32, image: int = 224,
                width: int = 64, blocks=(3, 4, 6, 3), classes: int = 1000):
    stages = len(blocks)
    params: Dict = {"stem": _w(gen, (width, 3, 7, 7))}
    for s in range(stages):
        cin = width * (2 ** max(s - 1, 0)) if s else width
        cout = width * (2 ** s)
        for b in range(blocks[s]):
            c_in = cin if b == 0 else cout
            params[f"s{s}b{b}"] = {
                "w1": _w(gen, (cout, c_in, 1, 1)),
                "w2": _w(gen, (cout, cout, 3, 3)),
                "w3": _w(gen, (cout, cout, 1, 1)),
                "proj": _w(gen, (cout, c_in, 1, 1)),
                "g1": _ones(gen, cout), "b1": _zeros(gen, cout),
                "g2": _ones(gen, cout), "b2": _zeros(gen, cout),
                "g3": _ones(gen, cout), "b3": _zeros(gen, cout),
            }
    params["head"] = _w(gen, (width * 2 ** (stages - 1), classes))

    def apply(params, x):
        h = F.relu(_conv(x, params["stem"], stride=2))
        for s in range(stages):
            for b in range(blocks[s]):
                p = params[f"s{s}b{b}"]
                stride = 2 if (b == 0 and s > 0) else 1
                r = F.relu(_bn(_conv(h, p["w1"], stride), p["g1"], p["b1"]))
                r = F.relu(_bn(_conv(r, p["w2"]), p["g2"], p["b2"]))
                r = _bn(_conv(r, p["w3"]), p["g3"], p["b3"])
                sc = _conv(h, p["proj"], stride)
                h = F.relu(r + sc)
        return h.mean((2, 3)) @ params["head"]

    def step(params, batch_):
        return _softmax_ce(apply(params, batch_["x"]), batch_["y"])

    dev = gen.device
    batch_ = {"x": torch.ones((batch, 3, image, image), dtype=_F32,
                              device=dev),
              "y": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    return step, params, batch_


# ---------------------------------------------------------------------------
# Inception-style (parallel mixed branches -> large graph fanout)
# ---------------------------------------------------------------------------
def make_inception(gen: torch.Generator, batch: int = 32, image: int = 224,
                   width: int = 64, n_blocks: int = 8, classes: int = 1000):
    params: Dict = {"stem": _w(gen, (width, 3, 3, 3))}
    c = width
    for i in range(n_blocks):
        params[f"mix{i}"] = {
            "b1": _w(gen, (c, c, 1, 1)), "b3a": _w(gen, (c, c, 1, 1)),
            "b3b": _w(gen, (c, c, 3, 3)), "b5a": _w(gen, (c, c, 1, 1)),
            "b5b": _w(gen, (c, c, 5, 5)), "bp": _w(gen, (c, 3 * c, 1, 1)),
        }
    params["head"] = _w(gen, (c, classes))

    def apply(params, x):
        h = F.relu(_conv(x, params["stem"], stride=2))
        for i in range(n_blocks):
            p = params[f"mix{i}"]
            br1 = F.relu(_conv(h, p["b1"]))
            br3 = F.relu(_conv(F.relu(_conv(h, p["b3a"])), p["b3b"]))
            br5 = F.relu(_conv(F.relu(_conv(h, p["b5a"])), p["b5b"]))
            h = F.relu(_conv(torch.cat([br1, br3, br5], 1), p["bp"]))
        return h.mean((2, 3)) @ params["head"]

    def step(params, batch_):
        return _softmax_ce(apply(params, batch_["x"]), batch_["y"])

    dev = gen.device
    batch_ = {"x": torch.ones((batch, 3, image, image), dtype=_F32,
                              device=dev),
              "y": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    return step, params, batch_


# ---------------------------------------------------------------------------
# DCGAN (generator + discriminator adversarial step)
# ---------------------------------------------------------------------------
def make_dcgan(gen: torch.Generator, batch: int = 128, image: int = 64,
               width: int = 64, z_dim: int = 100):
    # ``image`` is the reference's argument, which its nets never read:
    # the real batch is 32x32, the size the generator makes
    g = {
        "fc": _w(gen, (z_dim, width * 4 * 4 * 4)),
        "c1": _w(gen, (width * 4, width * 2, 4, 4)),
        "c2": _w(gen, (width * 2, width, 4, 4)),
        "c3": _w(gen, (width, 3, 4, 4)),
    }
    d = {
        "c1": _w(gen, (width, 3, 4, 4)),
        "c2": _w(gen, (width * 2, width, 4, 4)),
        "c3": _w(gen, (width * 4, width * 2, 4, 4)),
        "fc": _w(gen, (width * 4, 1)),
    }
    params = {"g": g, "d": d}

    def generator(g, z):
        h = (z @ g["fc"]).reshape(-1, g["c1"].shape[0], 4, 4)
        h = F.relu(_conv_t(h, g["c1"]))
        h = F.relu(_conv_t(h, g["c2"]))
        return torch.tanh(_conv_t(h, g["c3"]))

    def discriminator(d, x):
        h = F.leaky_relu(_conv(x, d["c1"], 2), 0.2)
        h = F.leaky_relu(_conv(h, d["c2"], 2), 0.2)
        h = F.leaky_relu(_conv(h, d["c3"], 2), 0.2)
        return h.mean((2, 3)) @ d["fc"]

    def step(params, batch_):
        fake = generator(params["g"], batch_["z"])
        d_fake = discriminator(params["d"], fake)
        d_real = discriminator(params["d"], batch_["x"])
        d_loss = torch.mean(F.softplus(-d_real)) + \
            torch.mean(F.softplus(d_fake))
        g_loss = torch.mean(F.softplus(-d_fake))
        return d_loss + g_loss

    dev = gen.device
    batch_ = {"x": torch.ones((batch, 3, 32, 32), dtype=_F32, device=dev),
              "z": torch.ones((batch, z_dim), dtype=_F32, device=dev)}
    return step, params, batch_


# ---------------------------------------------------------------------------
# GNMT (LSTM encoder-decoder with attention)
# ---------------------------------------------------------------------------
def _lstm_cell(carry, xt, w):
    h, c = carry
    z = torch.cat([xt, h], -1) @ w
    i, f, g, o = torch.chunk(z, 4, -1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def _lstm_scan(w, h0, c0, xs):
    """xs: (S, B, I); w: (I+H, 4H)."""
    _, hs = recurrent_scan(_lstm_cell, (h0, c0), xs, (w,))
    return hs


def make_gnmt(gen: torch.Generator, batch: int = 64, seq: int = 50,
              hidden: int = 512, vocab: int = 32000, layers: int = 4):
    params: Dict = {
        "src_embed": _w(gen, (vocab, hidden), scale=0.02),
        "tgt_embed": _w(gen, (vocab, hidden), scale=0.02),
        "attn": _w(gen, (hidden, hidden)),
        "head": _w(gen, (2 * hidden, vocab)),
    }
    for i in range(layers):
        params[f"enc{i}"] = _w(gen, (2 * hidden, 4 * hidden))
    for i in range(layers):
        params[f"dec{i}"] = _w(gen, (2 * hidden, 4 * hidden))

    def step(params, batch_):
        src = F.embedding(batch_["src"].to(torch.long),
                          params["src_embed"]).transpose(0, 1)
        tgt = F.embedding(batch_["tgt"].to(torch.long),
                          params["tgt_embed"]).transpose(0, 1)
        b = src.shape[1]
        h0 = torch.zeros((b, hidden), dtype=_F32, device=src.device)
        hs = src
        for i in range(layers):
            hs = _lstm_scan(params[f"enc{i}"], h0, h0, hs)
        ds = tgt
        for i in range(layers):
            ds = _lstm_scan(params[f"dec{i}"], h0, h0, ds)
        # Luong attention: decoder states attend over encoder states.
        scores = torch.einsum("sbh,tbh->bst", hs @ params["attn"], ds)
        # the product in the layout JAX's einsum computes it (hs's free
        # dim first), so the tracked bmm has the reference's orientation
        ctx = torch.einsum("sbh,bst->bht", hs,
                           torch.softmax(scores, 1)).permute(2, 0, 1)
        feat = torch.cat([ds, ctx], -1)
        logits = feat @ params["head"]
        return _softmax_ce(logits, batch_["tgt"].transpose(0, 1))

    dev = gen.device
    batch_ = {"src": torch.ones((batch, seq), dtype=torch.int32, device=dev),
              "tgt": torch.ones((batch, seq), dtype=torch.int32, device=dev)}
    return step, params, batch_


# ---------------------------------------------------------------------------
# Transformer (the reference's decoder-only model at the paper's width)
# ---------------------------------------------------------------------------
def transformer_config(d_model: int = 512, n_layers: int = 6,
                       vocab: int = 32000) -> ModelConfig:
    """The reference's ``paper-transformer`` config: dense attention, so
    the tracked step runs plain ops."""
    return ModelConfig(
        name="paper-transformer", family="dense", n_layers=n_layers,
        d_model=d_model, n_heads=8, n_kv_heads=8, d_ff=4 * d_model,
        vocab_size=vocab, use_flash=False)


def make_transformer(gen: torch.Generator, batch: int = 32, seq: int = 128,
                     d_model: int = 512, n_layers: int = 6,
                     vocab: int = 32000):
    cfg = transformer_config(d_model, n_layers, vocab)
    params = tfm.init_params(cfg, seed=int(gen.initial_seed()),
                             device=gen.device)

    def step(params, batch_):
        loss, _ = tfm.loss_fn(params, cfg, batch_)
        return loss

    tokens = torch.ones((batch, seq), dtype=torch.int32, device=gen.device)
    return step, params, {"tokens": tokens, "labels": tokens}


ZOO: Dict[str, Callable] = {
    "resnet50": make_resnet,
    "inception_v3": make_inception,
    "dcgan": make_dcgan,
    "gnmt": make_gnmt,
    "transformer": make_transformer,
}


def leaves(params) -> List[torch.Tensor]:
    """The parameter tensors of a net, in a fixed order: a nested dict's
    values depth-first in insertion order, or a module's parameters."""
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    if isinstance(params, dict):
        return [t for v in params.values() for t in leaves(v)]
    return [params]


def _rebuild(params, new: List[torch.Tensor]):
    """``params`` with its leaves replaced, in :func:`leaves` order."""
    it = iter(new)

    def go(p):
        if isinstance(p, dict):
            return {k: go(v) for k, v in p.items()}
        return next(it)
    if isinstance(params, torch.nn.Module):
        return list(it)
    return go(params)


def make_train_iteration(name: str, seed: int = 0, grad: bool = True,
                         device=None, **kw):
    """Return ``(iteration_fn, params, batch)``: forward, backward and the
    SGD update, the paper's unit, on ``device`` (default ``cuda``).

    ``iteration(params, batch)`` returns ``(loss, new params)``: the new
    leaves in a tree like ``params`` (for the Transformer's module, the
    list of its new parameters).  With ``grad=False`` the step alone
    (the loss) comes back.  The parameters require grad."""
    dev = torch_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    step, params, batch = ZOO[name](gen, **kw)
    for t in leaves(params):
        t.requires_grad_(grad)
    if not grad:
        return step, params, batch

    def iteration(params, batch_):
        ps = leaves(params)
        loss = step(params, batch_)
        grads = torch.autograd.grad(loss, ps)
        # the paper's "iteration" covers the weight update too (Sec. 2.1)
        new = [p.detach() - 1e-3 * g for p, g in zip(ps, grads)]
        return loss.detach(), _rebuild(params, new)

    return iteration, params, batch
