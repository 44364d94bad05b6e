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
k-means on the card is held to the CPU from a shared start on
well-separated modes and is deterministic; the EnCodec encoder on the card
is held to its CPU twin; a feature-seeded model's batched forward equals
its rows alone, bit for bit.  The int16 upload wire's table gather on the
card returns the host's table bit for bit, and a PCM16 signal's spans give
the same codes on the wire and as float32.  CUDA-graph replays of the
forward give the eager forward's bits, in argmin and stochastic mode, and
follow codebooks replaced after the capture; K2 with its seed in device
memory gives the by-value entry's bits.  The reconstruction metric suite
on the card is held to the same code on the CPU.
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
               seed=7, enable_codebook_cache=False)
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


def test_k2_device_seed_equals_the_by_value_seed(card):
    """The entry a graph captures reads the seed from device memory when
    it runs: the same codes, errors and sums as the seed passed by value,
    and another value in the buffer samples another way."""
    cb, x = _inputs(card, 81, 4096, seed=6)
    seed = torch.tensor([123456789], dtype=torch.int64, device=card)
    before = rvq_kernel.sample_launches
    by_value = rvq_kernel.rvq_encode_cuda(cb, x, 0.5, seed=123456789)
    seeded = rvq_kernel.rvq_encode_cuda(cb, x, 0.5, seed=seed)
    assert rvq_kernel.sample_launches == before + 2
    for a, b in zip(by_value, seeded):
        assert torch.equal(a, b)
    seed.fill_(7)
    assert torch.equal(rvq_kernel.rvq_encode_cuda(cb, x, 0.5, seed=seed)[0],
                       rvq_kernel.rvq_encode_cuda(cb, x, 0.5, seed=7)[0])
    with pytest.raises(ValueError):
        rvq_kernel.rvq_encode_cuda(cb, x, 0.5, seed=seed.int())


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
                               enable_reconstruction=True,
                               enable_codebook_cache=False, device=card)
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
               enable_reconstruction=True, seed=3,
               enable_codebook_cache=False)
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


# K1 at the M of span groups: 2, 4 and 8 rows of the 30 s bucket's 81
# frames.
@pytest.mark.parametrize("m", [162, 324, 648])
def test_kernel_at_span_group_shapes(card, m):
    cb, x = _inputs(card, m, 4096, seed=m)
    _check_against_plain(cb, x)


def _card_tokenizer(card):
    """float32 (TF32 off): no batch-size-dependent cuDNN algorithm then
    moves a bit that changes a code, so groups must equal single rows."""
    from nat_tpu_torch.models.tokenizer import NeuralAudioTokenizer

    tok = NeuralAudioTokenizer(semantic_dim=32, acoustic_dim=32,
                               codebook_size=512, n_mels=16,
                               semantic_arch="spectral", seed=7,
                               compute_dtype="float32",
                               enable_codebook_cache=False, device=card)
    tok.ensure_initialized()
    return tok


def _group_against_single_rows(tok, chunks):
    """Codes ``[rows, N, T]`` of one padded group of ``chunks`` (2 K1
    launches) and of each chunk in a forward of its own."""
    from nat_tpu_torch.models.tokenizer import SpanMeta

    bucket = chunks[0].shape[1]
    metas = [SpanMeta(0, 0, bucket, 0, 22050, bucket, bucket)] * len(chunks)
    before = rvq_kernel.launches
    out, _ = tok.dispatch_prepared_group(chunks, metas, 8)
    rows = list(tok.finalize_span_group(out, metas, want_features=False))
    assert rvq_kernel.launches == before + 2
    single = [tok.tokenize_span(chunk, 0, 0, bucket, 0, 22050,
                                want_features=False) for chunk in chunks]

    def codes(outs):
        return np.stack([np.concatenate([o["semantic_codes"][:, 0],
                                         o["acoustic_codes"][:, 0]])
                         for o in outs])
    return codes(rows), codes(single)


def test_grouped_forward_agrees_with_single_rows(card):
    """The default tokenizer at full width (bf16, wav2vec2-base, seeded
    random weights): eight 30 s-bucket spans as one ``[8, bucket]``
    forward against each span alone.  The resampler and the positional
    conv run row by row; the other convolutions may take other cuDNN
    algorithms for a batch of 8, so codes are held to the near-tie
    budget."""
    from nat_tpu_torch.models.tokenizer import NeuralAudioTokenizer

    tok = NeuralAudioTokenizer(semantic_arch="wav2vec2",
                               enable_codebook_cache=False, device=card)
    assert tok.compute_dtype == "bfloat16" and tok.row_invariant
    n = np.arange(30 * 22050) / 22050
    rng = np.random.default_rng(3)
    chunks = [(0.4 * np.sin(2 * np.pi * (180.0 + 40.0 * i) * n)
               + 0.05 * rng.standard_normal(n.size)).astype(np.float32)[None]
              for i in range(8)]
    grouped, single = _group_against_single_rows(tok, chunks)
    assert (grouped != single).mean() <= TIE_BUDGET


def test_feature_seeded_forward_is_batch_invariant(card):
    """A ``kmeans`` model at full width (bf16, wav2vec2-base, seeded
    random weights) runs its encoders one row at a time: eight 30 s
    spans as one ``[8, bucket]`` forward give the features and codes of
    each span alone, bit for bit."""
    from nat_tpu_torch.models.tokenizer import NeuralAudioTokenizer

    tok = NeuralAudioTokenizer(semantic_arch="wav2vec2",
                               codebook_init_method="kmeans",
                               enable_codebook_cache=False, device=card)
    tok.ensure_initialized()
    assert tok.batch_invariant and tok.compute_dtype == "bfloat16"
    wave = torch.from_numpy((0.3 * np.random.default_rng(4).standard_normal(
        (8, 30 * 22050))).astype(np.float32)).to(card)
    out = tok.forward(wave, 22050)
    alone = [tok.forward(wave[i:i + 1], 22050) for i in range(8)]
    for key, dim in (("semantic_features", 0), ("acoustic_features", 0),
                     ("semantic_codes", 1), ("acoustic_codes", 1)):
        assert torch.equal(out[key], torch.cat([o[key] for o in alone], dim))


def test_grouped_forward_equals_single_rows_in_float32(card):
    """One ``[4, bucket]`` group (three spans and a zero row) against
    single-row forwards of the same spans, in float32 (TF32 off): the
    codes are identical."""
    tok = _card_tokenizer(card)
    rng = np.random.default_rng(3)
    chunks = [(0.3 * rng.standard_normal((1, 4 * 22050))).astype(np.float32)
              for _ in range(3)]
    grouped, single = _group_against_single_rows(tok, chunks)
    np.testing.assert_array_equal(grouped, single)


def test_pinned_prefetch_equals_a_blocking_fetch(card):
    """Codes and losses read from the pinned buffers of the fetch stream,
    after their event, equal a blocking ``.cpu()`` of the same outputs."""
    tok = _card_tokenizer(card)
    chunk = (0.3 * np.random.default_rng(4).standard_normal(
        (1, 2 * 22050))).astype(np.float32)
    out, meta = tok.dispatch_span(chunk, 0, 0, chunk.shape[1], 0, 22050)
    tok._prefetch_outputs(out, want_features=False)
    host, done = out["_host"]
    assert all(t.is_pinned() for t in host.values())
    prefetched = tok.finalize_span(out, meta, want_features=False)
    blocking = {k: out[k].cpu().numpy() for k in ("semantic_codes",
                                                  "acoustic_codes")}
    valid = prefetched["semantic_codes"].shape[-1]
    for key, value in blocking.items():
        np.testing.assert_array_equal(prefetched[key], value[:, :, :valid])
    assert prefetched["losses"] == tok.row_losses(
        {k: v.cpu().numpy() for k, v in out["losses"].items()}, 0)


def test_pipelined_iter_chunks_on_card_matches_sequential(card, monkeypatch):
    """The staged, prefetched span loop with groups of 8 against groups of
    1 on a 70 s signal: K1 launches are 2 per plan item, and the tokens
    are the same."""
    tok = _card_tokenizer(card)
    audio = (0.3 * np.random.default_rng(5).standard_normal(
        (1, 70 * 22050))).astype(np.float32)
    codes, launched = {}, {}
    for group in ("1", "8"):
        monkeypatch.setenv("NAT_TPU_STREAM_GROUP", group)
        before = rvq_kernel.launches
        out = tok(audio, want_features=False)
        launched[group] = rvq_kernel.launches - before
        codes[group] = np.stack(out["semantic_codes"] + out["acoustic_codes"])
    assert launched == {"1": 8, "8": 6}
    np.testing.assert_array_equal(codes["1"], codes["8"])


def test_decode_tokens_on_card_matches_cpu(card):
    """``decode_tokens`` on the card (float32 decoder, TF32 off, in a bf16
    tokenizer) against the same weights and codes on the CPU, within 1e-4
    on values in [-1, 1]; TF32 is as it was afterwards."""
    from nat_tpu_torch.models.tokenizer import NeuralAudioTokenizer

    cfg = dict(semantic_dim=32, acoustic_dim=32, codebook_size=512,
               n_mels=16, semantic_arch="spectral",
               enable_reconstruction=True, seed=5,
               enable_codebook_cache=False)
    cpu = NeuralAudioTokenizer(**cfg, device="cpu")
    tok = NeuralAudioTokenizer(**cfg, device=card)
    assert tok.compute_dtype == "bfloat16"
    rng = np.random.default_rng(0)
    sem = [rng.integers(0, 512, (1, 300)) for _ in range(4)]
    acc = [rng.integers(0, 512, (1, 300)) for _ in range(4)]
    tf32 = torch.backends.cudnn.allow_tf32
    out = tok.decode_tokens(sem, acc)
    assert torch.backends.cudnn.allow_tf32 == tf32
    ref = cpu.decode_tokens(sem, acc)
    assert out.shape == ref.shape == (1, 300 * 512)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def _gliding_tone(seed: int, seconds: float, sr: int = 22050) -> np.ndarray:
    """A tone gliding 220-580 Hz every 2 s, with noise and a burst every
    0.22 s (pitch and onsets that the music metrics can follow)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f = 220.0 + 180.0 * (t % 2.0)
    x = 0.4 * np.sin(2 * np.pi * np.cumsum(f) / sr)
    x += 0.02 * rng.standard_normal(t.size)
    for at in range(int(0.1 * sr), t.size - 400, int(0.22 * sr)):
        x[at:at + 400] += 0.6 * rng.standard_normal(400)
    return x.astype(np.float32)


def test_metric_suite_on_card_matches_cpu(card):
    """The reconstruction metrics of a 60 s pair (the reconstruction 300
    samples shorter, with DC) on the card against the same code on the
    CPU: the eight fields within 1e-6 relative, the dominant-pitch tracks
    and onset candidates equal, the float32 magnitudes numpy's ``abs`` of
    the card's complex64 bit for bit, and the mel product IEEE float32
    with TF32 switched on around it."""
    from nat_tpu_torch.eval import audio_metrics as am
    from nat_tpu_torch.eval import librosa_compat as lc
    from nat_tpu_torch.eval.metrics import TokenizationEvaluator

    sr = 22050
    a = _gliding_tone(0, 60.0)
    recon = ((0.8 * a + 0.2 * _gliding_tone(1, 60.0))[:-300]
             + 0.05).astype(np.float32)
    ev = TokenizationEvaluator(sr)
    on_card = ev._reconstruction_metrics(a, recon, card)
    on_cpu = ev._reconstruction_metrics(a, recon, torch.device("cpu"))
    assert list(on_card) == list(on_cpu)
    for key, value in on_cpu.items():
        assert on_card[key] == pytest.approx(value, rel=1e-6, abs=0), key
        assert value != 0.0, key

    n = recon.size
    signals = {"o": a[:n], "r": recon}
    spectra = [am.Spectra({k: torch.from_numpy(v).double().to(dev)
                           for k, v in signals.items()}, sr)
               for dev in (card, torch.device("cpu"))]
    tracks = [am._tracks(sp, ("o", "r")).cpu() for sp in spectra]
    assert torch.equal(*tracks)
    masks = [am._onset_masks(sp, ("o", "r")).cpu() for sp in spectra]
    assert torch.equal(*masks)
    assert (masks[0].sum(-1) > 100).all()
    sp = spectra[0]
    for n_fft, hop in ((512, 128), (1024, 256), (2048, 512)):
        z = lc.stft(sp.signals["o"], n_fft, hop).cpu().numpy()
        mag = sp.mag(("o",), n_fft, hop)[0].cpu().numpy()
        assert mag.dtype == np.float32
        assert np.array_equal(np.abs(z), mag), (n_fft, hop)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    mag = sp.mag(("o",))[0]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with_tf32_on = lc.mel_power(mag, sr)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    fb = torch.from_numpy(lc.mel_fb(sr, 2048)).double().to(card)
    exact = fb @ (mag.double() ** 2)
    err = ((with_tf32_on.double() - exact).abs() / exact.clamp(min=1e-30))
    assert err.max().item() < 1e-5      # TF32's 10-bit mantissa: ~1e-3


@pytest.mark.parametrize("t,new_t", [(1500, 81), (12911, 12911 * 512)])
def test_interp_positions_on_card_equal_the_cpu_ones(card, t, new_t):
    """The resize positions made on the card are the CPU's bits (each step
    is one elementwise float32 op, so no contraction changes them)."""
    from nat_tpu_torch.ops.interp import _positions

    on_card = _positions(t, new_t, card)
    on_cpu = _positions(t, new_t, "cpu")
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)


def _modes(n=4000, d=32, k=8, seed=7):
    rng = np.random.default_rng(seed)
    modes = rng.standard_normal((k, d)).astype(np.float32) * 10.0
    mode_of = rng.integers(0, k, n)
    return (modes[mode_of]
            + rng.standard_normal((n, d)).astype(np.float32)), mode_of


def test_kmeans_on_card_matches_cpu(card):
    """From numpy's random start (the same on both devices), taking the
    first seed whose start has a row in every one of 8 well-separated
    modes: equal assignments, centres and inertia within float32
    summation order, the same validation outcome.  Two card runs of one
    seed give the same bits (the one-hot centroid sums are deterministic),
    k-means++ included, and TF32 stays as the process had it."""
    from nat_tpu_torch.quant import seeding

    x, mode_of = _modes()
    seed = next(s for s in range(100_000) if len(set(
        mode_of[np.random.default_rng(s).permutation(len(x))[:8]])) == 8)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    got = seeding.kmeans_torch(x, 8, seed=seed, init="random", device="cuda")
    assert torch.backends.cuda.matmul.allow_tf32 == tf32
    want = seeding.kmeans_torch(x, 8, seed=seed, init="random", device="cpu")
    assert np.array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
    assert abs(got[2] - want[2]) <= 1e-5 * abs(want[2])
    assert seeding._validate_clusters(x, got[0], got[1])
    for init in ("random", "kmeans++"):
        a = seeding.kmeans_torch(x, 64, seed=3, init=init, device="cuda")
        b = seeding.kmeans_torch(x, 64, seed=3, init=init, device="cuda")
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_seanet_on_card_matches_cpu(card):
    """The EnCodec encoder (random weights at the 24 kHz model's widths,
    two resnet-free stages) in float32 with TF32 off on the card against
    the same module on the CPU."""
    from nat_tpu_torch.models import encodec

    rng = np.random.default_rng(0)

    def conv(cout, cin, k, stride=1, pre_elu=False):
        return ("conv", {"w": (rng.standard_normal((cout, cin, k))
                               / np.sqrt(cin * k)).astype(np.float32),
                         "b": np.zeros(cout, np.float32), "stride": stride,
                         "pre_elu": pre_elu})

    lstm = {k: [(rng.standard_normal(shape) * 0.05).astype(np.float32)
                for _ in range(2)]
            for k, shape in (("w_ih", (256, 64)), ("w_hh", (256, 64)),
                             ("b_ih", (256,)), ("b_hh", (256,)))}
    params = {"layers": [conv(32, 1, 7), conv(64, 32, 4, 2, True),
                         ("lstm", lstm), conv(16, 64, 7, 1, True)]}
    wave = torch.from_numpy((rng.standard_normal((2, 48000)) * 0.3).astype(
        np.float32))
    cpu = encodec.SEANetEncoder(params).eval()
    card_enc = encodec.SEANetEncoder(params).to("cuda").eval()
    bridge = encodec.EncodecFeatureBridge.__new__(encodec.EncodecFeatureBridge)
    bridge.encoder, bridge.device = card_enc, torch.device("cuda")
    with torch.no_grad():
        want = cpu(wave)
    got = bridge.latents(wave.cuda()).cpu()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def test_int16_wire_on_card_equals_float32(card, monkeypatch):
    """The wire is on by default on the card: every plan item of a 40 s
    PCM16 signal goes as int16 (half the bytes), the gather gives the
    float32 batch bit for bit, and the codes equal the float32 upload's."""
    from nat_tpu_torch.dsp import pcm

    table = pcm.conversion_table(np.float32(0.6103516))
    vals = torch.arange(-32768, 32768, dtype=torch.int16, device=card)
    got = pcm.convert_on_device(vals, torch.from_numpy(table).to(card))
    assert np.array_equal(got.cpu().numpy().view(np.uint32),
                          table.view(np.uint32))
    assert pcm.device_conversion_exact(np.float32(0.6103516), card)
    tok = _card_tokenizer(card)
    i16 = np.random.default_rng(9).integers(-20000, 20000, 40 * 22050)
    wave = (i16.astype(np.float32) / np.float32(32768))
    wave = (wave / np.float32(np.abs(wave).max() + np.float32(1e-8)))[None]
    codes, sent = {}, {}
    for wire in ("default", "0"):
        if wire == "0":
            monkeypatch.setenv("NAT_TPU_PCM16_WIRE", "0")
        tok.upload_stats.update(int16=0, float32=0, bytes=0)
        out = tok(wave, want_features=False, reconstruct=False)
        codes[wire] = np.stack(out["semantic_codes"] + out["acoustic_codes"])
        sent[wire] = dict(tok.upload_stats)
    assert sent["default"]["float32"] == 0 and sent["default"]["int16"] >= 2
    assert sent["0"]["int16"] == 0
    assert 2 * sent["default"]["bytes"] == sent["0"]["bytes"]
    np.testing.assert_array_equal(codes["default"], codes["0"])


def _graph_twins(card, monkeypatch, **kw):
    """Two float32 card tokenizers of one seed: one through the CUDA-graph
    cache, one eager."""
    from nat_tpu_torch.models.tokenizer import NeuralAudioTokenizer

    monkeypatch.setenv("NAT_TPU_AOT_CACHE", "1")
    cfg = dict(semantic_dim=32, acoustic_dim=32, codebook_size=512,
               n_mels=16, semantic_arch="spectral", seed=7,
               compute_dtype="float32", enable_codebook_cache=False,
               device=card, **kw)
    graphed, eager = NeuralAudioTokenizer(**cfg), NeuralAudioTokenizer(**cfg)
    for tok in (graphed, eager):
        tok.ensure_initialized()
    eager._graphs.capture = None
    return graphed, eager


def _outputs(tok, wave):
    out = tok.forward(wave, 22050)
    return {k: out[k] for k in ("semantic_codes", "acoustic_codes",
                                "semantic_features", "acoustic_features")}


def test_graph_replays_equal_eager_and_follow_a_new_codebook(card,
                                                             monkeypatch):
    """Eager at the first sight, captured at the second, replayed after:
    codes and features byte-identical to the eager twin's, K1 counted twice
    per replay; codebooks replaced after the capture change the replay as
    they change the eager forward."""
    graphed, eager = _graph_twins(card, monkeypatch)
    wave = torch.from_numpy((0.3 * np.random.default_rng(8).standard_normal(
        (4, 4 * 22050))).astype(np.float32)).to(card)
    ref = _outputs(eager, wave)
    for sight in range(3):
        before = rvq_kernel.launches
        out = _outputs(graphed, wave)
        torch.cuda.synchronize()
        assert rvq_kernel.launches == before + 2
        for key, value in ref.items():
            assert torch.equal(out[key], value), (sight, key)
    stats = graphed._graphs.stats
    assert (stats["captures"], stats["replays"], stats["failed"]) == (1, 2, 0)
    rng = np.random.default_rng(9)
    books = [rng.standard_normal((4, 512, 32)).astype(np.float32)
             for _ in range(2)]
    for tok in (graphed, eager):
        tok._set_codebooks(*books)
    new_ref = _outputs(eager, wave)
    for _ in range(2):
        out = _outputs(graphed, wave)
        for key, value in new_ref.items():
            assert torch.equal(out[key], value), key
    assert not torch.equal(new_ref["semantic_codes"], ref["semantic_codes"])
    assert stats["captures"] == 2 and stats["failed"] == 0


def test_stochastic_graph_replays_take_each_spans_seeds(card, monkeypatch):
    """In stochastic mode every replay samples with its span's own seeds
    (copied into the graph's seed buffer): the graphed tokenizer's spans
    equal the eager twin's, one by one, and K2 counts 2 a forward."""
    graphed, eager = _graph_twins(card, monkeypatch, stochastic=True,
                                  temperature=0.5)
    wave = torch.from_numpy((0.3 * np.random.default_rng(10).standard_normal(
        (1, 4 * 22050))).astype(np.float32)).to(card)
    seen = []
    for span in range(4):
        before = rvq_kernel.sample_launches
        out, ref = _outputs(graphed, wave), _outputs(eager, wave)
        torch.cuda.synchronize()
        assert rvq_kernel.sample_launches == before + 4
        assert torch.equal(out["semantic_codes"], ref["semantic_codes"])
        assert torch.equal(out["acoustic_codes"], ref["acoustic_codes"])
        seen.append(out["semantic_codes"])
    assert graphed._graphs.stats["replays"] == 3
    assert not torch.equal(seen[-1], seen[-2])
