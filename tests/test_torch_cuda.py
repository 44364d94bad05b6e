"""Tests of the PyTorch port that need a CUDA card (marker ``cuda``).

They skip without a card.  On the card they run without the JAX test
configuration, which imports JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

The kernels are held against their plain PyTorch versions on the card: K1
(argmin; ragged rows, codes and depths, unaligned rows, and duplicated
codebook rows whose ties go to the lowest index) and K2 (sampling, fed the
uniforms the kernel's own Philox draws) against the plain chain, K3 (the
training encode) against autograd through the plain straight-through
version.  K1 and K2 must give the same bits under every launch plan.
A small tokenizer on the card is held
against the same tokenizer on the CPU (float32, TF32 off), and a small
train step on the card must go through K3 and keep float32 params.
Near-tie budget 2% (layer 0 exact in argmin mode), as in
tests/test_torch_rvq.py.
"""

import numpy as np
import pytest
import torch

from nat_tpu_torch.ops import rvq_kernel
from nat_tpu_torch.quant import rvq as plain

pytestmark = pytest.mark.cuda

TIE_BUDGET = 0.02
QSUM_ATOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _check_against_plain(cb, x):
    before = rvq_kernel.launches
    codes, err, qsum = rvq_kernel.rvq_encode_cuda(cb, x)
    ref_codes, ref_err, ref_qsum = plain.rvq_chain(cb, x)
    torch.cuda.synchronize()
    assert rvq_kernel.launches == before + 1
    codes = codes.long()
    assert torch.equal(codes[0], ref_codes[0])
    assert (codes != ref_codes).float().mean().item() <= TIE_BUDGET
    agree = (codes == ref_codes).all(dim=0)
    torch.testing.assert_close(qsum[agree], ref_qsum[agree], rtol=0,
                               atol=QSUM_ATOL)
    torch.testing.assert_close(err[:, agree], ref_err[:, agree], rtol=1e-4,
                               atol=1e-4)


# Row counts around the row tiles (1, 17, 81 and 88 in one tile of 32 or
# 96 rows, 129 just past 128, 648 a kernel-phase batch) against code counts
# around the 32-code chunk; then depths that are not a multiple of the
# 32-deep slice (500) or are one slice (32).
@pytest.mark.parametrize("m,k,d", [
    (m, k, 512) for m in (1, 17, 81, 88, 129, 648)
    for k in (1, 1000, 4096, 4097)] + [
    (200, 4096, 512), (81, 4096, 32), (81, 4096, 500), (17, 4097, 500),
    (129, 1000, 32)])
def test_kernel_matches_plain_chain(card, m, k, d):
    rng = np.random.default_rng(m * 7 + k + d)
    cb = torch.from_numpy(rng.standard_normal((4, k, d)).astype(
        np.float32)).to(card)
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(
        np.float32)).to(card)
    _check_against_plain(cb, x)


@pytest.mark.parametrize("d", [512, 3])
def test_kernel_takes_rows_off_the_16_byte_grid(card, d):
    """x starting one float into its storage, or a depth that is not a
    multiple of 4, goes through the kernel's one-float copies."""
    rng = np.random.default_rng(d)
    cb = torch.from_numpy(rng.standard_normal((4, 300, d)).astype(
        np.float32)).to(card)
    flat = torch.from_numpy(rng.standard_normal(81 * d + 1).astype(
        np.float32)).to(card)
    x = flat[1:].view(81, d)
    assert x.data_ptr() % 16 != 0
    _check_against_plain(cb, x)


def test_kernel_ties_go_to_the_lowest_index(card):
    """A codebook whose rows repeat (within a 32-code chunk and across
    chunks): every pick is the first copy, as in torch.argmin."""
    rng = np.random.default_rng(21)
    base = rng.standard_normal((4, 1024, 512)).astype(np.float32)
    cb = np.concatenate([base, base, base[:, :100]], axis=1)   # K = 2148
    cb[:, 1::2] = cb[:, 0::2][:, :cb[:, 1::2].shape[1]]
    cb = torch.from_numpy(np.ascontiguousarray(cb)).to(card)
    x = torch.from_numpy(rng.standard_normal((81, 512)).astype(
        np.float32)).to(card)
    codes = rvq_kernel.rvq_encode_cuda(cb, x)[0].long()
    ref_codes = plain.rvq_chain(cb, x)[0]
    torch.cuda.synchronize()
    assert torch.equal(codes, ref_codes)
    first = torch.stack([
        (cb[n][:, None, :] == cb[n][None, codes[n], :]).all(dim=2).int()
        .argmax(dim=0) for n in range(4)])
    assert torch.equal(codes, first)


@pytest.mark.parametrize("temperature", [None, 0.5])
def test_kernel_results_do_not_depend_on_the_plan(card, temperature):
    """The same rows under each row tile, and as part of calls whose M gets
    another tile (17 rows: one tile of 32; 81 rows: one of 96), give the
    same codes, errors and sums bit for bit, K1 and K2 alike."""
    rng = np.random.default_rng(5)
    cb = torch.from_numpy(rng.standard_normal((4, 4096, 512)).astype(
        np.float32)).to(card)
    x = torch.from_numpy(rng.standard_normal((81, 512)).astype(
        np.float32)).to(card)
    sms, per_sm = rvq_kernel.resident_blocks(card.index or 0,
                                             temperature is not None)
    outs = []
    for tile in rvq_kernel.ROW_TILES:
        plan = rvq_kernel.plan_with_tile(
            81, 4096, tile, sms * per_sm[rvq_kernel.ROW_TILES.index(tile)])
        outs.append(rvq_kernel.rvq_encode_cuda(cb, x, temperature, 3, plan))
    head = rvq_kernel.rvq_encode_cuda(cb, x[:17].contiguous(), temperature, 3)
    assert rvq_kernel.launch_plan(17, 4096, sms, per_sm).row_tile == 32
    assert rvq_kernel.launch_plan(81, 4096, sms, per_sm).row_tile == 96
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
    codes, err, qsum = outs[0]
    assert torch.equal(head[0], codes[:, :17])
    assert torch.equal(head[1], err[:, :17])
    assert torch.equal(head[2], qsum[:17])


def test_kernel_refuses_wrong_inputs(card):
    cb = torch.zeros(2, 8, 4, device=card)
    with pytest.raises(TypeError):
        rvq_kernel.rvq_encode_cuda(cb, torch.zeros(3, 4, device=card,
                                                   dtype=torch.float64))
    with pytest.raises(ValueError):
        rvq_kernel.rvq_encode_cuda(cb, torch.zeros(4, 3, device=card).T)
    with pytest.raises(ValueError):
        rvq_kernel.rvq_encode_cuda(cb, torch.zeros(3, 5, device=card))


def test_tokenizer_on_card_matches_cpu(card):
    from nat_tpu_torch.models.tokenizer import NeuralAudioTokenizer

    cfg = dict(semantic_dim=32, acoustic_dim=32, codebook_size=512,
               n_mels=16, semantic_arch="spectral", compute_dtype="float32",
               seed=7)
    audio = (0.3 * np.random.default_rng(0).standard_normal(
        (1, 5 * 22050))).astype(np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        before = rvq_kernel.launches
        out[device] = NeuralAudioTokenizer(**cfg, device=device)(
            audio, want_features=False)
        launched = rvq_kernel.launches - before
        assert launched == (2 if device == "cuda" else 0)
    a = np.stack(out["cuda"]["semantic_codes"] + out["cuda"]["acoustic_codes"])
    b = np.stack(out["cpu"]["semantic_codes"] + out["cpu"]["acoustic_codes"])
    assert a.shape == b.shape
    assert (a != b).mean() <= TIE_BUDGET


def _inputs(card, m, k, seed, n=4, d=512):
    rng = np.random.default_rng(seed)
    cb = torch.from_numpy(rng.standard_normal((n, k, d)).astype(
        np.float32)).to(card)
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(
        np.float32)).to(card)
    return cb, x


def test_k2_uniforms_are_the_host_philox(card):
    u = rvq_kernel.philox_uniforms_cuda(12345678901, 3, 81, 1000, card)
    ref = np.stack([plain.philox_uniforms(12345678901, n, 81, 1000)
                    for n in range(3)])
    assert torch.equal(u.cpu(), torch.from_numpy(ref))


@pytest.mark.parametrize("m,k", [(81, 4096), (200, 4096), (81, 1000),
                                 (17, 4097), (129, 1000), (1, 33)])
def test_k2_matches_plain_on_the_same_uniforms(card, m, k):
    cb, x = _inputs(card, m, k, seed=m + k)
    before = rvq_kernel.sample_launches
    codes, err, qsum = rvq_kernel.rvq_encode_cuda(cb, x, 0.5, seed=99)
    u = rvq_kernel.philox_uniforms_cuda(99, 4, m, k, card)
    ref_codes, ref_err, ref_qsum = plain.rvq_chain(cb, x, 0.5, u)
    torch.cuda.synchronize()
    assert rvq_kernel.sample_launches == before + 1
    codes = codes.long()
    assert (codes != ref_codes).float().mean().item() <= TIE_BUDGET
    agree = (codes == ref_codes).all(dim=0)
    torch.testing.assert_close(qsum[agree], ref_qsum[agree], rtol=0,
                               atol=QSUM_ATOL)


def test_k2_seeded_and_cold_limit(card):
    cb, x = _inputs(card, 81, 4096, seed=5)
    a = rvq_kernel.rvq_encode_cuda(cb, x, 0.5, seed=7)[0]
    b = rvq_kernel.rvq_encode_cuda(cb, x, 0.5, seed=7)[0]
    c = rvq_kernel.rvq_encode_cuda(cb, x, 0.5, seed=8)[0]
    argmin = rvq_kernel.rvq_encode_cuda(cb, x)[0]
    cold = rvq_kernel.rvq_encode_cuda(cb, x, 1e-6, seed=7)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert (cold != argmin).float().mean().item() <= TIE_BUDGET
    assert (a != argmin).float().mean().item() > 0.5


@pytest.mark.parametrize("b,t", [(4, 22), (1, 81)])
def test_k3_matches_plain_autograd(card, b, t):
    cb, x = _inputs(card, b * t, 4096, seed=b * t)
    w = torch.randn(b, t, 512, generator=torch.Generator().manual_seed(0)
                    ).to(card)

    def grads(encode):
        cb_ = cb.clone().requires_grad_(True)
        x_ = x.reshape(b, t, 512).clone().requires_grad_(True)
        codes, q, losses = encode(plain.RVQState(cb_, cb_.new_zeros(
            cb.shape[:2]), cb_.detach()), x_)
        ((q * w).sum() + 0.3 * losses["commitment_loss"]
         + 0.7 * losses["codebook_loss"]).backward()
        return codes, cb_.grad, x_.grad

    before = (rvq_kernel.train_launches, rvq_kernel.launches)
    codes, g_cb, g_x = grads(rvq_kernel.rvq_encode_train)
    ref_codes, ref_g_cb, ref_g_x = grads(plain.rvq_encode_ste)
    torch.cuda.synchronize()
    assert (rvq_kernel.train_launches, rvq_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(codes, ref_codes)
    torch.testing.assert_close(g_x, ref_g_x, rtol=0, atol=1e-5)
    torch.testing.assert_close(g_cb, ref_g_cb, rtol=0, atol=1e-6)


def test_train_step_on_card_goes_through_k3(card):
    from nat_tpu_torch.models.tokenizer import NeuralAudioTokenizer
    from nat_tpu_torch.parallel.optim import Optimizer
    from nat_tpu_torch.parallel.train import make_train_state, make_train_step

    tok = NeuralAudioTokenizer(semantic_dim=32, acoustic_dim=32,
                               codebook_size=512, n_mels=16,
                               semantic_arch="spectral",
                               enable_reconstruction=True, device=card)
    opt = Optimizer(1e-3)
    state = make_train_state(tok, opt)
    step = make_train_step(tok, opt)
    batch = (0.3 * np.random.default_rng(1).standard_normal(
        (2, 22050))).astype(np.float32)
    before = rvq_kernel.train_launches
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert rvq_kernel.train_launches == before + 2
    assert all(torch.isfinite(v).item() for v in metrics.values())
    assert state.sem_rvq.ema_count.sum().item() > 0


def test_train_state_on_card_holds_the_float32_params(card, tmp_path):
    """The card's tokenizer computes in bfloat16. Its train state holds the
    float32 values that the same seed gives on the CPU, exactly; after a
    step, save_model writes the train state's float32 params."""
    from nat_tpu_torch.models.tokenizer import (MODULE_NAMES,
                                                NeuralAudioTokenizer)
    from nat_tpu_torch.parallel.optim import Optimizer
    from nat_tpu_torch.parallel.train import make_train_state, make_train_step
    from nat_tpu_torch.runtime.checkpoint import save_model

    cfg = dict(semantic_dim=32, acoustic_dim=32, codebook_size=512,
               n_mels=16, semantic_arch="spectral",
               enable_reconstruction=True, seed=3)
    ref = NeuralAudioTokenizer(**cfg, device="cpu")
    ref.ensure_initialized()
    tok = NeuralAudioTokenizer(**cfg, device=card)
    opt = Optimizer(1e-3)
    state = make_train_state(tok, opt)
    assert tok.mel_encoder.proj.weight.dtype == torch.bfloat16
    for name in MODULE_NAMES:
        ours = state.params[name].state_dict()
        for k, v in getattr(ref, name).state_dict().items():
            assert ours[k].dtype == torch.float32
            assert torch.equal(ours[k].cpu(), v), f"{name}.{k}"
    batch = (0.3 * np.random.default_rng(2).standard_normal(
        (2, 22050))).astype(np.float32)
    state, _ = make_train_step(tok, opt)(state, batch)
    tok.load_float_params({name: state.params[name].state_dict()
                           for name in MODULE_NAMES})
    save_model(str(tmp_path / "m.pt"), tok)
    saved = torch.load(tmp_path / "m.pt", weights_only=True)["params"]
    for name in MODULE_NAMES:
        for k, v in state.params[name].state_dict().items():
            assert torch.equal(saved[name][k], v.cpu()), f"{name}.{k}"


def test_feature_extractor_gelu_is_tanh_under_bf16_autocast(card,
                                                            monkeypatch):
    """Under the train step's bf16 autocast, CUDA's GroupNorm returns
    float32; the wav2vec2 feature extractor keeps the conv's bf16 after it,
    so every GELU is the tanh form, as in the reference's bf16 modules."""
    from nat_tpu_torch.models import semantic

    calls = []
    real = semantic.F.gelu

    def spy(x, approximate="none"):
        calls.append((x.dtype, approximate))
        return real(x, approximate=approximate)

    monkeypatch.setattr(semantic.F, "gelu", spy)
    fe = semantic.FeatureExtractor(((8, 10, 5), (8, 3, 2))).to(card)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        fe(torch.randn(1, 400, device=card))
    assert calls == [(torch.bfloat16, "tanh")] * 2
