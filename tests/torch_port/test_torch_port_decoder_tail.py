"""The port's decoder tail (scldm_torch.ops.fused_decoder) against the JAX
Pallas kernel run in interpret mode, on the same numpy inputs, at ragged
shapes that fit no tile.

Both sides round the same operands (kfull, qp, the attention probabilities,
vproj, hn, w12) to bf16 and accumulate in f32, so they agree up to the order
of their sums and the rare bf16 rounding it flips: the forward to 1e-3 of
the logits' largest magnitude, and each gradient to 1e-2 of its own largest
magnitude (the JAX kernel rounds its reduced gradients to bf16 per tile, the
port after the whole sum; the largest gap seen is 3.6e-3, for qp). The same
holds at the other widths the JAX gate dispatches (`WIDTHS`: E = 16, 64 and
128 with head widths 8 and 16, ragged latent-token counts, the hidden widths
of the MLP rule). The CUDA kernels themselves are compared with the plain
version on the card in test_torch_port_cuda.py."""

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


def _make(G, B, seed, e=E, m=M, hid=HID):
    rng = np.random.default_rng(seed)

    def f(*s):
        return (rng.normal(size=s) * 0.3).astype(np.float32)

    raw = dict(ln2g=f(e) + 1.0, ln2b=f(e), w1=f(e, hid), w2=f(e, hid), wmlp=f(hid, e),
               wmu=f(e, 1), bmu=f(1))
    return dict(qp=f(G, e), q=f(G, e), k=f(B, m, e), v=f(B, m, e), wproj=f(e, e), **raw)


def _jax_tail(x, h=H):
    w = jfd.pack_weights(*(x[n] for n in RAW))
    kf, vp = jfd.build_attention_operands(x["k"], x["v"], x["wproj"], h)
    # tiles that divide neither axis: the ragged edges are padded
    return jfd.fused_decoder_tail(x["qp"], x["q"], kf, vp, w, h, 1e-8, 64, 8, 64, 8, True)


def _port_tail(fn, x, h=H):
    w = port.pack_weights(*(x[n] for n in RAW))
    kf, vp = port.build_attention_operands(x["k"], x["v"], x["wproj"], h)
    return fn(x["qp"], x["q"], kf, vp, w, h, 1e-8)


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
    with pytest.raises(ValueError, match="built for"):  # 64 rows are not 3 heads' blocks
        port._check(x["qp"], x["q"], kf, vp, w, 3)
    meta = [t.to("meta") for t in (x["qp"], x["q"], kf, vp)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.decoder_tail_fwd(*meta, [t.to("meta") for t in w], H, 1e-8)
    assert port._check(x["qp"], x["q"], kf, vp, w, H) == (3, 20, E, M, HID)
    # 2 heads over the same rows: 32 latent tokens of head width 16, taken
    assert port._check(x["qp"], x["q"], kf, vp, w, 2) == (3, 20, E, 2 * M, HID)


@pytest.mark.parametrize("B,G", [(128, 17_002), (19, 300), (1, 77)])
def test_backward_workspace_floats(B, G):
    """The specialised backward's workspace holds every CTA's partials, which
    a second kernel adds in a fixed order (no atomics): per block of 16 cells
    dqp and dq of every gene; per tile of 64 genes and cell dvproj and
    dkfull's head blocks; per CTA dw12 and the vector gradients (padded to a
    multiple of 4), and those summed over the gene tiles per cell block."""
    n_gt, n_cb = -(-G // 64), -(-B // 16)
    nw = 2 * E * HID + 3 * E + HID + 1
    nw += -nw % 4
    want = n_cb * 2 * G * E + n_gt * B * H * M * (E + E // H) + (n_gt + 1) * n_cb * nw
    assert port.decoder_tail_bwd_workspace_floats(B, G, HID) == want
    assert nw % 4 == 0 and nw >= 2 * E * HID + 3 * E + HID + 1
    # the training step's: 108.3 M floats, 433 MB, most of it dvproj's partials
    if (B, G) == (128, 17_002):
        assert 4 * want == 433_197_696


# (E, n_head, M, Hd, B, G) at the widths the JAX gate sends the kernels: E =
# 16, 64 and 128 with MLP(E)'s hidden width (multiple_of 4), a ragged M, head
# widths 8 and 16, a hidden width off the multiples of 8, and more latent
# tokens than one 64-key tile holds (72 and 130: two and three tiles)
WIDTHS = [(16, 2, 8, 44, 3, 40), (64, 4, 32, 172, 3, 37), (128, 8, 64, 344, 2, 21),
          (32, 4, 13, 90, 3, 30), (16, 2, 72, 44, 3, 40), (32, 4, 130, 88, 2, 24)]


@pytest.mark.parametrize("e,h,m,hid,B,G", WIDTHS)
def test_plain_tail_matches_pallas_interpret_at_other_widths(e, h, m, hid, B, G):
    """The plain tail, forward and every gradient, against JAX's Pallas tail
    in interpret mode at the widths the any-width kernels take; tolerances
    as at the dentate width (forward 1e-3, gradients 1e-2 of their largest)."""
    x = _make(G, B, 5, e, m, hid)
    names = ("qp", "q", "k", "v", "wproj", *RAW)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    want = np.asarray(_jax_tail(jx, h))
    tx = {k: torch.from_numpy(v).requires_grad_() for k, v in x.items()}
    out = _port_tail(port.decoder_tail_reference, tx, h)
    assert out.shape == want.shape == (B, G)
    assert np.abs(out.detach().numpy() - want).max() < 1e-3 * np.abs(want).max()

    def jloss(*args):
        return _jloss(_jax_tail({**jx, **dict(zip(names, args))}, h))

    jgrads = jax.grad(jloss, argnums=tuple(range(len(names))))(*(jx[n] for n in names))
    _loss(out).backward()
    for name, w in zip(names, jgrads):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0, name
        assert np.abs(tx[name].grad.numpy() - w).max() < 1e-2 * scale, name


def _hidden(e, multiple_of):
    """nn/layers.py's MLP rule: 2/3 of 4E rounded up to `multiple_of`."""
    hidden = int(2 * (e * 4) / 3)
    return multiple_of * ((hidden + multiple_of - 1) // multiple_of)


def test_backward_hidden_width_outside_the_kernel_raises():
    """A hidden width off the specialised backward's 88 takes the any-width
    backward (both ways), so does any number of latent tokens (65 here), and
    only a shape outside the kernels' band raises before any launch: here 3
    heads, which do not divide E = 32."""
    assert port.SPECIALISED_HIDDEN == HID
    x = {k: torch.from_numpy(v) for k, v in _make(20, 3, 4).items()}
    w = list(port.pack_weights(*(x[n] for n in RAW)))
    w[2], w[3] = torch.zeros(E, 2 * 96), torch.zeros(1, 96)
    kf, vp = port.build_attention_operands(x["k"], x["v"], x["wproj"], H)
    assert port._check(x["qp"], x["q"], kf, vp, w, H) == (3, 20, E, M, 96)
    assert port.kernel_takes(E, H, M, 96) and not port.specialised(E, H, M, 96, True)
    big = torch.zeros(3, H * 65, E)
    assert port._check(x["qp"], x["q"], big, big, w, H) == (3, 20, E, 65, 96)
    three = torch.zeros(3, 3 * M, E)
    with pytest.raises(ValueError, match="built for"):
        port._check(x["qp"], x["q"], three, three, w, 3)


def test_kernels_take_every_width_the_gate_sends():
    """Every E from 16 to 128 in steps of 16, each head count giving a head
    width of 8, 16, 32 or 64, 1 to 1,000 latent tokens (one 64-key tile and
    more) and every hidden width of the MLP rule at multiple_of 1 to 64 take
    the kernels, both ways; the dentate decoder's shape takes the
    specialised design (its backward only at hidden 88). Outside the grid
    the kernels also take E off the multiples of 16 and head widths 4 and
    128, and 65 or 128 latent tokens at the dentate and parse1m widths."""
    hidden = set()
    for e in range(16, 129, 16):
        for hd in (8, 16, 32, 64):
            if e % hd:
                continue
            for m in (1, 13, 16, 32, 64, 65, 128, 130, 1000):
                for mo in (1, 2, 4, 8, 16, 32, 64):
                    hid = _hidden(e, mo)
                    hidden.add(hid)
                    assert port.kernel_takes(e, e // hd, m, hid), (e, hd, m, hid)
    assert {44, 88, 172, 256, 344} <= hidden
    assert port.specialised(32, 4, 16, 88, True) and port.specialised(32, 4, 16, 96, False)
    assert not port.specialised(32, 4, 16, 96, True) and not port.specialised(64, 4, 32, 172, False)
    for e, h, m in ((24, 3, 16), (40, 10, 17), (16, 4, 8), (128, 1, 5)):
        assert port.kernel_takes(e, h, m, 64), (e, h, m)
    for e, h, m, hid in ((32, 4, 65, 88), (128, 8, 128, 344), (64, 4, 128, 172)):
        assert port.kernel_takes(e, h, m, hid) and not port.specialised(e, h, m, hid, False)


# the refused band: E past 128 (which the gate sends to the algebraic tail),
# a head count that does not divide E, no latent token
@pytest.mark.parametrize("e,h,m,hid", [(192, 8, 64, 512), (48, 5, 72, 128), (160, 4, 16, 428),
                                       (64, 5, 16, 172), (32, 4, 0, 88)])
def test_shapes_outside_the_kernels_raise(e, h, m, hid):
    """Outside the band the kernels take, the launch's check raises before
    any launch; no shape falls back to the plain version on the card."""
    assert not port.kernel_takes(e, h, m, hid)
    x = {k: torch.from_numpy(v) for k, v in _make(10, 2, 4, e, max(m, 1), hid).items()}
    w = list(port.pack_weights(*(x[n] for n in RAW)))
    if e % h:
        kf = vp = torch.zeros(2, h * m, e)
    else:
        kf, vp = port.build_attention_operands(x["k"][:, :m], x["v"][:, :m], x["wproj"], h)
    with pytest.raises(ValueError, match="built for"):
        port._check(x["qp"], x["q"], kf.contiguous(), vp.contiguous(), w, h)


@pytest.mark.parametrize("e,h,m,hid", [(64, 4, 32, 172), (128, 8, 64, 344), (16, 2, 8, 44)])
def test_any_width_workspace(e, h, m, hid):
    """The any-width design's workspace at the training step's B = 128: the
    packed bf16 operands, d(hh) (f32) and bf(hn) (bf16) of every pair, E
    padded to 64 or 128, and the partials, under the earlier design's 983.2
    MB (E = 64) and 550.0 MB (E = 128); past one 64-key tile the softmax's
    row max, sum and D of every (cell, head, gene) join it. The forward's is
    the packed operands alone."""
    B, G = 128, 17_002 if e <= 64 else 2_000
    ep = 64 if e <= 64 else 128
    got = port.decoder_tail_bwd_workspace_floats(B, G, hid, e, h, m)
    assert (4 + 2) * B * G * ep // 4 < got < (983.2e6 if e <= 64 else 550.0e6) / 4
    fwd = port.decoder_tail_fwd_workspace_floats(B, G, hid, e, h, m)
    assert 0 < fwd < got // 4
    assert fwd * 4 >= 2 * (G * ep + 2 * B * h * m * ep + 2 * 32 * -(-hid // 32) * ep)
    more = port.decoder_tail_bwd_workspace_floats(B, G, hid, e, h, 2 * m + 65)
    assert more - got >= 3 * B * h * G
    assert port.decoder_tail_fwd_workspace_floats(B, G, HID) == 0
