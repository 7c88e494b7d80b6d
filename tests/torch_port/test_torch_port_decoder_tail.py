"""The port's decoder tail (scldm_torch.ops.fused_decoder) against the JAX
Pallas kernel run in interpret mode, on the same numpy inputs, at ragged
shapes that fit no tile.

Both sides round the same operands (kfull, qp, the attention probabilities,
vproj, hn, w12) to bf16 and accumulate in f32, so they agree up to the order
of their sums and the rare bf16 rounding it flips: the forward to 1e-3 of
the logits' largest magnitude, and each gradient to 1e-2 of its own largest
magnitude (the JAX kernel rounds its reduced gradients to bf16 per tile, the
port after the whole sum; the largest gap seen is 3.6e-3, for qp). The CUDA kernels themselves are compared with the
plain version on the card in test_torch_port_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scldm_tpu.ops import fused_decoder as jfd
from scldm_torch.ops import fused_decoder as port

H, M, E, HID = 4, 16, 32, 88
RAW = ("ln2g", "ln2b", "w1", "w2", "wmlp", "wmu", "bmu")


@pytest.fixture(autouse=True)
def _exact_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _make(G, B, seed):
    rng = np.random.default_rng(seed)

    def f(*s):
        return (rng.normal(size=s) * 0.3).astype(np.float32)

    raw = dict(ln2g=f(E) + 1.0, ln2b=f(E), w1=f(E, HID), w2=f(E, HID), wmlp=f(HID, E),
               wmu=f(E, 1), bmu=f(1))
    return dict(qp=f(G, E), q=f(G, E), k=f(B, M, E), v=f(B, M, E), wproj=f(E, E), **raw)


def _jax_tail(x):
    w = jfd.pack_weights(*(x[n] for n in RAW))
    kf, vp = jfd.build_attention_operands(x["k"], x["v"], x["wproj"], H)
    # tiles that divide neither axis: the ragged edges are padded
    return jfd.fused_decoder_tail(x["qp"], x["q"], kf, vp, w, H, 1e-8, 64, 8, 64, 8, True)


def _port_tail(fn, x):
    w = port.pack_weights(*(x[n] for n in RAW))
    kf, vp = port.build_attention_operands(x["k"], x["v"], x["wproj"], H)
    return fn(x["qp"], x["q"], kf, vp, w, H, 1e-8)


def _loss(out):
    # a non-uniform cotangent, so that every gradient is exercised
    return (out * 0.1).tanh().sum()


def _jloss(out):
    return jnp.tanh(out * 0.1).sum()


@pytest.mark.parametrize("fn", ["decoder_tail_reference", "decoder_tail"])
def test_forward_matches_pallas_interpret(fn):
    x = _make(150, 12, 0)
    want = np.asarray(_jax_tail({k: jnp.asarray(v) for k, v in x.items()}))
    before = port.DECODER_TAIL_FWD_LAUNCHES.count
    got = _port_tail(getattr(port, fn), {k: torch.from_numpy(v) for k, v in x.items()})
    assert got.shape == want.shape == (12, 150)
    mag = np.abs(want).max()
    assert np.abs(got.detach().numpy() - want).max() < 1e-3 * mag
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert port.DECODER_TAIL_FWD_LAUNCHES.count == before


@pytest.mark.parametrize("fn", ["decoder_tail_reference", "decoder_tail"])
def test_gradients_match_pallas_interpret(fn):
    x = _make(70, 9, 1)
    names = ("qp", "q", "k", "v", "wproj", *RAW)
    jx = {k: jnp.asarray(v) for k, v in x.items()}

    def jloss(*args):
        return _jloss(_jax_tail({**jx, **dict(zip(names, args))}))

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(*(jx[n] for n in names))
    tx = {k: torch.from_numpy(v).requires_grad_() for k, v in x.items()}
    before = port.DECODER_TAIL_BWD_LAUNCHES.count
    _loss(_port_tail(getattr(port, fn), tx)).backward()
    assert port.DECODER_TAIL_BWD_LAUNCHES.count == before
    for name, w in zip(names, want):
        w = np.asarray(w)
        got = tx[name].grad.numpy()
        scale = np.abs(w).max()
        assert scale > 0, name
        assert np.abs(got - w).max() < 1e-2 * scale, name


def test_function_matches_reference_autograd():
    """On CPU tensors the autograd Function (recompute VJP) and the plain
    version's own autograd agree to rounding."""
    x = _make(33, 5, 2)
    grads = []
    for fn in (port.decoder_tail_reference, port.decoder_tail):
        tx = {k: torch.from_numpy(v).requires_grad_() for k, v in x.items()}
        _loss(_port_tail(fn, tx)).backward()
        grads.append({k: t.grad for k, t in tx.items()})
    for k in x:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-6, atol=1e-6)


def test_shape_checks_and_devices():
    x = {k: torch.from_numpy(v) for k, v in _make(20, 3, 3).items()}
    w = port.pack_weights(*(x[n] for n in RAW))
    kf, vp = port.build_attention_operands(x["k"], x["v"], x["wproj"], H)
    with pytest.raises(ValueError, match="q must be"):
        port._check(x["qp"], x["q"][:5], kf, vp, w, H)
    with pytest.raises(ValueError, match="built for"):
        port._check(x["qp"], x["q"], kf, vp, w, 2)
    meta = [t.to("meta") for t in (x["qp"], x["q"], kf, vp)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.decoder_tail_fwd(*meta, [t.to("meta") for t in w], H, 1e-8)
    assert port._check(x["qp"], x["q"], kf, vp, w, H) == (3, 20, E, M, HID)


@pytest.mark.parametrize("B,G", [(128, 17_002), (19, 300), (1, 77)])
def test_backward_workspace_floats(B, G):
    """The backward's workspace holds every CTA's partials, which a second
    kernel adds in a fixed order (no atomics): per block of 16 cells dqp and
    dq of every gene; per tile of 64 genes and cell dvproj and dkfull's head
    blocks; per CTA dw12 and the vector gradients (padded to a multiple of
    4), and those summed over the gene tiles per cell block."""
    n_gt, n_cb = -(-G // 64), -(-B // 16)
    nw = 2 * E * HID + 3 * E + HID + 1
    nw += -nw % 4
    want = n_cb * 2 * G * E + n_gt * B * H * M * (E + E // H) + (n_gt + 1) * n_cb * nw
    assert port.decoder_tail_bwd_workspace_floats(B, G, HID) == want
    assert nw % 4 == 0 and nw >= 2 * E * HID + 3 * E + HID + 1
    # the training step's: 108.3 M floats, 433 MB, most of it dvproj's partials
    if (B, G) == (128, 17_002):
        assert 4 * want == 433_197_696


def test_backward_hidden_width_outside_the_kernel_raises():
    """The backward kernel is compiled for the dentate decoder's hidden width
    (88); the launch's check refuses another before any launch, while the
    forward takes it."""
    assert port.BWD_HIDDEN == (HID,)
    x = {k: torch.from_numpy(v) for k, v in _make(20, 3, 4).items()}
    w = list(port.pack_weights(*(x[n] for n in RAW)))
    w[2], w[3] = torch.zeros(E, 2 * 96), torch.zeros(1, 96)
    kf, vp = port.build_attention_operands(x["k"], x["v"], x["wproj"], H)
    assert port._check(x["qp"], x["q"], kf, vp, w, H) == (3, 20, E, M, 96)
    with pytest.raises(ValueError, match="backward kernel is built for Hd"):
        port._check(x["qp"], x["q"], kf, vp, w, H, backward=True)
