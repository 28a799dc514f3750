"""The port's CUDA kernels against their plain PyTorch versions, and the
tolerances that hold them there: the flash kernels, the tensor-core burn
(``mxu_burn``) and the memory stream (``hbm_stream``).

The kernel cases need a CUDA device and skip without one; run them on a
GPU host with ``python -m pytest --noconftest tests/test_torch_cuda.py``.

Tolerance (``kernels.plain_excess``): every element within 2% of its own
magnitude plus 16 bf16 epsilons of the output's RMS.  The kernels
multiply bf16 tiles on the tensor cores and round the probabilities p and
dS to bf16 before the second product of each tile, where the plain
versions stay in f32 throughout; both round their outputs to bf16.

The planted-fault cases run on the CPU too: at the bench shape (S=256,
D=128, causal), where a late row of O or a late key tile of dK/dV is two
orders smaller than row 0 or key 0, the tolerance passes the kernels'
stated numerics (on the CPU an f32 emulation of them, on the card the
kernels) and fails a kernel that skips a tile or never rescales its
running softmax sums.

``hbm_stream``'s kernel equals its plain version bit for bit.
``mxu_burn``'s is held by ``kernels.mxu_excess`` (every element within 8 *
sqrt(iters) bf16 unit roundoffs of the output's RMS) on bounded inputs, x
random normal and w a random orthogonal matrix, at the pattern's tile and
depth; on the CPU the candidate is the same chain summed in f64, another
summation order.  Both checks must reject planted faults: a stream block
left unwritten, a chain one step short.
"""

import numpy as np
import pytest
import torch

from tpumon_torch.loadgen import kernels as K

TILE = 64  # the kernels' tile, rows and keys


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The CPU cases run bench-shape plain versions; two threads keep them
    from crowding the suite's other workers."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(params=["cpu", "cuda"])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device(request.param)


def _inputs(device, BH, S, D, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn((BH, S, D), generator=g, device=device,
                        dtype=torch.float32).to(torch.bfloat16)
            for _ in range(4)]


def _close(got, want):
    assert K.plain_excess(got, want) <= 1.0


# (BH, S, D, causal, block_q, block_k): the bench shape, padded causal
# tails, D=64, a ragged kernel tile (S not a multiple of 64), non-causal;
# the flash pattern's reference shape (4 heads of 1024: 64 q tiles, a
# grid shorter than the SMs), causal and not; one head (B*H=1), a ragged
# last tile after a long loop (S=1000), D=64 at the bench length, D=64
# over 16 long non-causal loops, a ragged D=64 tile in a lone non-causal
# tile; 768 q tiles, more than two waves of two blocks an SM, so the
# block order's remap of the second wave meets every q tile
CASES = [
    (64, 256, 128, True, 128, 128),
    (64, 256, 128, False, 128, 128),
    (6, 100, 128, True, 100, 100),
    (6, 96, 64, False, 32, 32),
    (4, 192, 64, True, 64, 64),
    (3, 40, 128, True, 8, 8),
    (4, 1024, 128, True, 128, 128),
    (4, 1024, 128, False, 128, 128),
    (1, 256, 128, True, 128, 128),
    (2, 1000, 128, True, 200, 200),
    (2, 1000, 64, False, 200, 200),
    (16, 256, 64, True, 128, 128),
    (16, 256, 64, False, 128, 128),
    (16, 1024, 64, False, 128, 128),
    (3, 100, 64, False, 100, 100),
    (192, 256, 128, True, 128, 128),
]


@pytest.mark.parametrize("BH,S,D,causal,bq,bk", CASES)
def test_kernels_match_plain(cuda, BH, S, D, causal, bq, bk):
    q, k, v, do = _inputs(cuda, BH, S, D)
    o, lse = K.flash_fwd(q, k, v, causal, bq, bk)
    torch.cuda.synchronize()
    o_ref, lse_ref = K.flash_fwd_plain(q, k, v, causal, bq, bk)
    _close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() < 1e-2
    delta = (do.float() * o_ref.float()).sum(-1)
    dq = K.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal, bq, bk)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal, bq, bk)
    torch.cuda.synchronize()
    _close(dq, K.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal,
                                    bq, bk))
    dk_ref, dv_ref = K.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta,
                                           causal, bq, bk)
    _close(dk, dk_ref)
    _close(dv, dv_ref)


def test_attention_autograd_runs_on_kernels(cuda):
    """flash_attention forward and backward on the card launch the three
    kernels, never the plain versions."""

    g = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn((2, 255, 4, 128), generator=g, device=cuda)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    before = dict(K.LAUNCHES)
    out = K.flash_attention(q, k, v, causal=True)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert K.LAUNCHES[name] == before[name] + 1


def test_kernel_refuses_unbuilt_head_dim(cuda):
    q, k, v, _ = _inputs(cuda, 2, 64, 32)
    with pytest.raises(ValueError):
        K.flash_fwd(q, k, v, True, 64, 64)


# ---- the tolerance against planted faults ------------------------------------

def _scores(q, k, *, unmask_diagonal=False):
    """Causal scores; ``unmask_diagonal``: the future keys of each
    diagonal 64-tile are kept too."""

    S = q.shape[1]
    s = q.float() @ k.float().mT * q.shape[-1] ** -0.5
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    if unmask_diagonal:
        tile = torch.arange(S, device=q.device) // TILE
        keep |= tile[:, None] == tile[None, :]
    return s.masked_fill(~keep, float("-inf"))


def _forward(q, k, v, *, round_p=False, rescale=True, k_stop=None):
    """Causal online-softmax O over 64-key tiles, as the forward kernel
    walks them.  ``round_p``: p rounded to bf16 for its product with V;
    ``rescale=False``: the running sums are never rescaled when a row's
    max moves; ``k_stop``: the tiles from there on are skipped."""

    s = _scores(q, k)
    BH, S, D = q.shape
    m = torch.full((BH, S, 1), float("-inf"), device=q.device)
    l = torch.zeros((BH, S, 1), device=q.device)
    acc = torch.zeros((BH, S, D), device=q.device)
    for j0 in range(0, k_stop or S, TILE):
        st = s[..., j0:j0 + TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(st - m_safe)
        corr = torch.exp(m - m_safe) if rescale else torch.ones_like(m)
        pv = p.bfloat16().float() if round_p else p
        acc = acc * corr + pv @ v[:, j0:j0 + TILE].float()
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
    return (acc / l.clamp_min(1e-20)).bfloat16()


def _backward(q, k, v, do, lse, delta, *, round_p=False, q_stop=None,
              k_stop=None, unmask_diagonal=False):
    """Causal dQ, dK, dV from p = exp(s - lse), over the rows before
    ``q_stop`` and the keys before ``k_stop``.  ``round_p``: p and dS
    rounded to bf16 before their second products; ``unmask_diagonal``: p
    left unmasked on the diagonal tiles."""

    p = torch.exp(_scores(q, k, unmask_diagonal=unmask_diagonal)
                  - lse[..., None])
    if q_stop is not None:
        p[:, q_stop:] = 0.0
    if k_stop is not None:
        p[..., k_stop:] = 0.0
    ds = (p * (do.float() @ v.float().mT - delta[..., None])
          * q.shape[-1] ** -0.5)
    if round_p:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    return tuple(t.bfloat16() for t in (ds @ k.float(), ds.mT @ q.float(),
                                        p.mT @ do.float()))


def _bench_case(device):
    """Bench-shape causal inputs (64 heads on the card, 4 on the CPU),
    the plain versions' outputs, and the candidate's: the kernels on the
    card, the f32 emulation of their numerics on the CPU."""

    BH = 64 if device.type == "cuda" else 4
    q, k, v, do = _inputs(device, BH, 256, 128, seed=3)
    o_p, lse = K.flash_fwd_plain(q, k, v, True, 128, 128)
    delta = (do.float() * o_p.float()).sum(-1)
    want = {"o": o_p,
            "dq": K.flash_bwd_dq_plain(q, k, v, do, lse, delta, True, 128,
                                       128)}
    want["dk"], want["dv"] = K.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                   True, 128, 128)
    if device.type == "cuda":
        got = {"o": K.flash_fwd(q, k, v, True, 128, 128)[0],
               "dq": K.flash_bwd_dq(q, k, v, do, lse, delta, True, 128, 128)}
        got["dk"], got["dv"] = K.flash_bwd_dkv(q, k, v, do, lse, delta,
                                               True, 128, 128)
        torch.cuda.synchronize()
    else:
        got = {"o": _forward(q, k, v, round_p=True)}
        got["dq"], got["dk"], got["dv"] = _backward(q, k, v, do, lse, delta,
                                                    round_p=True)
    return (q, k, v, do, lse, delta), want, got


def test_tolerance_passes_kernel_numerics(device):
    _, want, got = _bench_case(device)
    for name in want:
        assert K.plain_excess(got[name], want[name]) <= 1.0, name


LAST = 256 - TILE
# (output, fault): a kernel that skips its last k tile (or part of it),
# never rescales its running sums, ends its dK/dV q loop one tile early,
# or leaves p unmasked on dQ's causal diagonal tile
FAULTS = [
    pytest.param("o", lambda a: _forward(*a[:3], k_stop=LAST),
                 id="fwd-last-k-tile"),
    pytest.param("o", lambda a: _forward(*a[:3], rescale=False),
                 id="fwd-no-rescale"),
    pytest.param("dq", lambda a: _backward(*a, k_stop=LAST)[0],
                 id="dq-last-k-tile"),
    pytest.param("dk", lambda a: _backward(*a, k_stop=LAST)[1],
                 id="dk-last-k-tile"),
    pytest.param("dv", lambda a: _backward(*a, k_stop=LAST)[2],
                 id="dv-last-k-tile"),
    # one warp's 16 keys: a limit of 2% of the tensor's largest |dK| (at
    # key 0) rejects this one by a margin of only 1.3x on the CPU case
    pytest.param("dk", lambda a: _backward(*a, k_stop=256 - 16)[1],
                 id="dk-last-16-keys"),
    pytest.param("dk", lambda a: _backward(*a, q_stop=LAST)[1],
                 id="dk-last-q-tile"),
    pytest.param("dv", lambda a: _backward(*a, q_stop=LAST)[2],
                 id="dv-last-q-tile"),
    pytest.param("dq", lambda a: _backward(*a, unmask_diagonal=True)[0],
                 id="dq-unmasked-diagonal"),
]


@pytest.mark.parametrize("output,fault", FAULTS)
def test_tolerance_fails_planted_fault(device, output, fault):
    args, want, _ = _bench_case(device)
    assert K.plain_excess(fault(args), want[output]) > 1.0


def _stale(x, j):
    """``x`` with the rows of tile j replaced by those of tile j - 1: what
    a kernel reads when a two-stage ring hands out a stage before its copy
    of tile j has landed (tile j - 2 for a ring that was never refilled
    is the same fault one stage further back)."""

    y = x.clone()
    y[:, j * TILE:(j + 1) * TILE] = x[:, (j - 1) * TILE:j * TILE]
    return y


def _stale_forward(args, j):
    q, k, v = args[:3]
    return K.flash_fwd_plain(q, _stale(k, j), _stale(v, j), True, 128,
                             128)[0]


def _stale_dq(args, j):
    q, k, v, do, lse, delta = args
    return K.flash_bwd_dq_plain(q, _stale(k, j), _stale(v, j), do, lse,
                                delta, True, 128, 128)


def _stale_backward(args, j):
    q, k, v, do, lse, delta = args
    return K.flash_bwd_dkv_plain(_stale(q, j), k, v, _stale(do, j),
                                 _stale(lse, j), _stale(delta, j), True,
                                 128, 128)


# (output, fault): key tile j of O's or dQ's loop, or q tile j of dK/dV's
# loop, read from a stale ring stage; j=2 is the first tile that reuses a
# stage
STALE_FAULTS = [
    pytest.param("o", lambda a, j: _stale_forward(a, j), id="fwd-stale-k"),
    pytest.param("dq", lambda a, j: _stale_dq(a, j), id="dq-stale-k"),
    pytest.param("dk", lambda a, j: _stale_backward(a, j)[0],
                 id="dk-stale-q"),
    pytest.param("dv", lambda a, j: _stale_backward(a, j)[1],
                 id="dv-stale-q"),
]


@pytest.mark.parametrize("j", [2, 3])
@pytest.mark.parametrize("output,fault", STALE_FAULTS)
def test_tolerance_fails_stale_ring_stage(device, output, fault, j):
    args, want, _ = _bench_case(device)
    assert K.plain_excess(fault(args, j), want[output]) > 1.0


# ---- the load-shaping kernels -------------------------------------------------

def _orthogonal_bf16(T, device, seed=2):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((T, T)))
    return torch.from_numpy(q.astype(np.float32)).to(device, torch.bfloat16)


def _mxu_case(device, iters=64):
    """Bounded inputs at the pattern's tile and depth: on the card as many
    tiles as the pattern burns, on the CPU two; the plain chain, and the
    candidate's (the kernel on the card, an f64-summed chain on the
    CPU)."""

    T = K.MXU_TILE
    n = K.mxu_tiles(device) if device.type == "cuda" else 2
    g = torch.Generator(device).manual_seed(1)
    x = torch.randn((n, T, T), generator=g, device=device).to(torch.bfloat16)
    w = _orthogonal_bf16(T, device)
    want = K.mxu_burn_plain(x, w, iters=iters)
    if device.type == "cuda":
        got = K.mxu_burn(x, w, iters=iters)
        torch.cuda.synchronize()
    else:
        got = x
        for _ in range(iters):
            got = (got.double() @ w.double()).to(torch.bfloat16)
    return x, w, want, got


@pytest.mark.parametrize("iters", [64, 1, 16])
def test_mxu_kernel_matches_plain(device, iters):
    _, _, want, got = _mxu_case(device, iters)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert K.mxu_excess(got, want, iters) <= 1.0


def test_mxu_tolerance_fails_chain_one_step_short(device):
    x, w, want, _ = _mxu_case(device)
    if device.type == "cuda":
        short = K.mxu_burn(x, w, iters=63)
        torch.cuda.synchronize()
    else:
        short = K.mxu_burn_plain(x, w, iters=63)
    assert K.mxu_excess(short, want, 64) > 1.0


def test_mxu_kernel_identity_and_single_tile(cuda):
    eye = torch.eye(256, device=cuda, dtype=torch.bfloat16)
    before = K.LAUNCHES["mxu_burn"]
    out = K.mxu_burn(eye, eye, iters=4)
    torch.cuda.synchronize()
    assert out.shape == (256, 256) and torch.equal(out, eye)
    assert K.LAUNCHES["mxu_burn"] == before + 1


def test_mxu_kernel_refuses_unbuilt_tile(cuda):
    x = torch.zeros((128, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        K.mxu_burn(x, x, iters=1)
    with pytest.raises(ValueError):
        K.mxu_burn(x.float(), x.float(), iters=1)


# the pattern's shapes on the CPU and the card, a tail of 3 scalars past the
# 16-byte vectors, and one exact (256, 1024) block
STREAM_SHAPES = [(2048, 4096), K.HBM_SHAPE["cuda"], (5, 3), (256, 1024)]


@pytest.mark.parametrize("shape", STREAM_SHAPES)
def test_hbm_stream_kernel_bitwise(cuda, shape):
    x = torch.randn(shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(0))
    before = K.LAUNCHES["hbm_stream"]
    got = K.hbm_stream(x)
    torch.cuda.synchronize()
    assert torch.equal(got, K.hbm_stream_plain(x))
    assert K.LAUNCHES["hbm_stream"] == before + 1


def test_hbm_stream_check_fails_unwritten_block(device):
    x = torch.randn((2048, 4096), device=device,
                    generator=torch.Generator(device).manual_seed(0))
    got = K.hbm_stream(x)
    fault = got.clone()
    fault[256:512, 1024:2048] = 0.0
    assert torch.equal(got, K.hbm_stream_plain(x))
    assert not torch.equal(fault, K.hbm_stream_plain(x))


def test_hbm_stream_kernel_refuses_other_dtypes(cuda):
    with pytest.raises(ValueError):
        K.hbm_stream(torch.zeros((256, 1024), device=cuda,
                                 dtype=torch.bfloat16))


@pytest.mark.parametrize("name,kernels", [
    ("mxu", {"mxu_burn"}), ("hbm", {"hbm_stream"}),
    ("mixed", {"mxu_burn", "hbm_stream"}), ("flash", {"flash_fwd"}),
    ("conv", set())])
def test_patterns_step_on_kernels(cuda, name, kernels):
    step, state = K.make_pattern(name, device=cuda)
    before = dict(K.LAUNCHES)
    state = step(step(state))
    torch.cuda.synchronize()
    launched = {k for k in K.LAUNCHES if K.LAUNCHES[k] > before[k]}
    assert launched == kernels
