"""The port's runtime layer on the CPU: the parameter cache, the CUDA-graph
forward cache's bookkeeping, and the utilities (heartbeat, the log
setters, progress, profiling, memory, warmup), held against the JAX
package where it has the same function.

The graph cache captures only on a card; here a stand-in capture (it runs
the forward once when "captured" and again into the same output tensors
at each "replay", as a graph writes its static outputs) drives the
bookkeeping: keys, eager first sight, capture at the second, replays,
invalidation, launch counts and output copies.  Sizes are tiny (spectral
encoder, dims 32, codebook 64, 16 mels); with the same weights the two
paths run the same float32 ops, so their codes are held equal, no
near-tie budget.
"""

import io
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from nat_tpu.utils import heartbeat as jax_heartbeat
from nat_tpu.utils import logging as jax_logging
from nat_tpu.utils import progress as jax_progress
from nat_tpu_torch import bridge
from nat_tpu_torch.models.tokenizer import NeuralAudioTokenizer
from nat_tpu_torch.ops import rvq_kernel
from nat_tpu_torch.runtime import aotcache, paramcache
from nat_tpu_torch.runtime.checkpoint import load_model, save_model
from nat_tpu_torch.runtime.pipeline import AudioTokenizationPipeline
from nat_tpu_torch.runtime.prewarm import prewarm_forwards
from nat_tpu_torch.utils import heartbeat as port_heartbeat
from nat_tpu_torch.utils import logging as port_logging
from nat_tpu_torch.utils import memory, profiling, progress, warmup

SR = 16000
TINY = dict(sample_rate=SR, semantic_dim=32, acoustic_dim=32,
            codebook_size=64, num_quantizers=8, n_mels=16, hop_length=64,
            codebook_init_method="random", seed=42, timebase="compat",
            compute_dtype="float32", semantic_arch="spectral",
            enable_codebook_cache=False)
TINY_W2V2 = dict(hidden=64, num_layers=2, num_heads=4, ffn_dim=128,
                 conv_layers=((32, 10, 5), (32, 3, 2), (32, 3, 2), (32, 3, 2),
                              (32, 3, 2), (32, 2, 2), (32, 2, 2)),
                 pos_conv_kernel=16, pos_conv_groups=4)
PIPE_CONFIG = {k: TINY[k] for k in ("semantic_dim", "acoustic_dim",
                                    "codebook_size", "n_mels", "hop_length")}


def _wave(seconds=1.0, seed=0, rows=1):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f = rng.uniform(150.0, 600.0, (rows, 1))
    return (0.5 * np.sin(2 * np.pi * f * t)
            + 0.05 * rng.standard_normal((rows, t.size))).astype(np.float32)


def _tokenizer(**over):
    return NeuralAudioTokenizer(**{**TINY, **over}, device="cpu")


def stand_in_capture(fn, static_inputs, pool, stream):
    """A CPU stand-in for ``aotcache.cuda_capture``: the outputs of one run
    are the static outputs, and a replay recomputes them into the same
    tensors.  Like a capture, it counts the forward's launches into the
    recording's tally (the plain chain on the CPU launches nothing, so the
    stand-in records the two RVQ calls a forward makes)."""
    outputs = fn(*static_inputs)
    rvq_kernel._count("launches")
    rvq_kernel._count("launches")

    def replay():
        fresh = fn(*static_inputs)
        pairs = []
        aotcache.map_tensors(lambda t: pairs.append(t), fresh)
        it = iter(pairs)
        aotcache.map_tensors(lambda t: t.copy_(next(it)), outputs)
    return replay, outputs


def _graphed(tok):
    tok._graphs = aotcache.ForwardGraphs(tok.device, capture=stand_in_capture)
    return tok


@pytest.fixture
def graphs_on(monkeypatch):
    monkeypatch.setenv("NAT_TPU_AOT_CACHE", "1")


# ---------------------------------------------------------------------------
# The parameter cache
# ---------------------------------------------------------------------------

@pytest.fixture
def param_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("NAT_TPU_PARAM_CACHE", "1")
    monkeypatch.setenv("NAT_TPU_PARAM_CACHE_DIR", str(tmp_path / "params"))
    return tmp_path / "params"


def _frames(pipe, wav):
    lines = []
    pipe.session().stream_audio(str(wav), lines.append)
    return [line for line in lines if '"event":"frame"' in line]


@pytest.mark.parametrize("arch", ["spectral", "wav2vec2"])
def test_param_cache_hit_equals_a_miss(param_cache, simple_wav, arch):
    """A hit gives the miss's float32 params bit for bit (the float params
    and the modules' own) and the same NDJSON frames."""
    config = dict(PIPE_CONFIG, semantic_arch=arch,
                  semantic_arch_config=TINY_W2V2 if arch == "wav2vec2"
                  else None)

    def pipe():
        return AudioTokenizationPipeline(
            model_config=config, device="cpu", deterministic_seed=42,
            enable_codebook_cache=False, enable_reconstruction=False)

    miss = pipe()
    assert len(list(param_cache.glob("*.pt"))) == 1
    hit = pipe()
    a, b = miss.tokenizer.float_params(), hit.tokenizer.float_params()
    assert set(a) == set(b)
    for name in a:
        assert set(a[name]) == set(b[name])
        for key in a[name]:
            assert torch.equal(a[name][key], b[name][key]), (name, key)
            assert torch.equal(getattr(miss.tokenizer, name).state_dict()[key],
                               getattr(hit.tokenizer, name).state_dict()[key])
    assert _frames(miss, simple_wav) == _frames(hit, simple_wav)


def test_param_cache_hit_of_a_checkpoint_keeps_its_float_params(
        param_cache, tmp_path, monkeypatch):
    """With a local wav2vec2 checkpoint the entry holds the merged trunk: a
    hit skips the checkpoint's parse, logs the reference's "(cached init)"
    line and keeps the float32 values of a bfloat16 tokenizer, as the miss
    did.  (A tiny trunk stands in for the parse of wav2vec2-base.)"""
    from nat_tpu_torch.models import tokenizer as tok_module
    from nat_tpu_torch.models.semantic import SemanticAudioEncoder
    from nat_tpu_torch.quant import checkpoint_io

    torch.manual_seed(3)
    trunk = SemanticAudioEncoder(output_dim=32, arch=TINY_W2V2).wav2vec2
    tree = bridge.wav2vec2_tree(trunk.state_dict(), TINY_W2V2["num_heads"])
    ckpt = tmp_path / "model.safetensors"
    ckpt.write_bytes(b"stand-in")
    parses = []

    def parse():
        parses.append(1)
        return {"wav2vec2": tree}

    monkeypatch.setattr(checkpoint_io, "find_local_checkpoint",
                        lambda name: ckpt)
    monkeypatch.setattr(tok_module, "load_pretrained_semantic_params", parse)
    kw = dict(semantic_arch="auto", semantic_arch_config=TINY_W2V2,
              compute_dtype="bfloat16")
    miss = _tokenizer(**kw)
    miss.ensure_initialized()
    lines = []
    monkeypatch.setattr(port_logging.logger, "info", lines.append)
    hit = _tokenizer(**kw)
    hit.ensure_initialized()
    assert len(parses) == 1
    assert lines == ["Semantic encoder: pretrained wav2vec2-base weights "
                     "(cached init)"]
    assert not hit.semantic_fallback and hit._float_params is not None
    for name, sd in miss.float_params().items():
        for key, value in sd.items():
            assert torch.equal(value, hit.float_params()[name][key]), key
            assert torch.equal(getattr(miss, name).state_dict()[key],
                               getattr(hit, name).state_dict()[key])
    wave = torch.from_numpy(_wave())
    assert torch.equal(miss.forward(wave, SR)["semantic_codes"],
                       hit.forward(wave, SR)["semantic_codes"])


def test_param_cache_key_moves_with_config_and_checkpoint(param_cache,
                                                          tmp_path):
    """As ``tests/test_aot_cache.py`` shows for JAX: another seed, width or
    encoder is another entry; so is another checkpoint identity (path,
    size, mtime); nothing of JAX enters the key."""
    _tokenizer().ensure_initialized()
    _tokenizer(seed=7).ensure_initialized()
    _tokenizer(semantic_dim=16).ensure_initialized()
    _tokenizer().ensure_initialized()                 # a hit: no new entry
    assert len(list(param_cache.glob("*.pt"))) == 3
    tok = _tokenizer()
    config = tok._init_cache_config(False)
    ckpt = tmp_path / "model.safetensors"
    ckpt.write_bytes(b"x" * 10)
    keys = {paramcache.params_key(config, "none", "cpu"),
            paramcache.params_key(config, paramcache.checkpoint_identity(ckpt),
                                  "cpu"),
            paramcache.params_key(config, "none", "cuda"),
            paramcache.params_key(dict(config, compute_dtype="bfloat16"),
                                  "none", "cpu")}
    ckpt.write_bytes(b"x" * 11)
    keys.add(paramcache.params_key(config, paramcache.checkpoint_identity(ckpt),
                                   "cpu"))
    assert len(keys) == 5
    assert "jax" not in paramcache._SOURCE_MODULES


def test_param_cache_unreadable_entry_is_replaced(param_cache, simple_wav):
    tok = _tokenizer()
    tok.ensure_initialized()
    (entry,) = param_cache.glob("*.pt")
    entry.write_bytes(b"garbage")
    again = _tokenizer()
    again.ensure_initialized()                 # must not raise
    for name, sd in tok.float_params().items():
        for key, value in sd.items():
            assert torch.equal(value, again.float_params()[name][key])
    assert entry.stat().st_size > 100          # written anew


def test_param_cache_off(tmp_path, monkeypatch):
    """Off under the tests' ``NAT_TPU_PARAM_CACHE=0`` and wherever it is
    set so: nothing is written."""
    assert paramcache.cache_enabled() is False      # conftest sets =0
    monkeypatch.setenv("NAT_TPU_PARAM_CACHE_DIR", str(tmp_path))
    _tokenizer().ensure_initialized()
    assert not list(tmp_path.iterdir())
    monkeypatch.delenv("NAT_TPU_PARAM_CACHE")
    assert paramcache.cache_enabled() is True       # the reference's default


# ---------------------------------------------------------------------------
# The CUDA-graph forward cache
# ---------------------------------------------------------------------------

def test_graph_cache_is_off_on_the_cpu_and_by_its_switch(monkeypatch):
    tok = _tokenizer()
    monkeypatch.setenv("NAT_TPU_AOT_CACHE", "1")
    assert not tok._graphs.enabled()          # no CPU graphs
    graphed = _graphed(_tokenizer())
    assert graphed._graphs.enabled()
    monkeypatch.setenv("NAT_TPU_AOT_CACHE", "0")
    assert not graphed._graphs.enabled()
    monkeypatch.delenv("NAT_TPU_AOT_CACHE")
    assert graphed._graphs.enabled()          # on by default
    assert aotcache.ForwardGraphs("cuda").capture is aotcache.cuda_capture


def test_graph_key_holds_what_decides_the_kernels():
    tok = _tokenizer()
    tok.ensure_initialized()
    key = dict(tok._graph_key(SR, (8, 16000), False))
    assert {"sr", "bucket", "rows", "reconstruct", "stochastic",
            "temperature", "compute_dtype", "arch", "arch_config",
            "row_invariant", "batch_invariant", "cudnn_allow_tf32",
            "cudnn_deterministic", "matmul_allow_tf32", "sample_rate",
            "semantic_dim", "acoustic_dim", "n_mels", "hop_length",
            "timebase"} <= set(key)
    assert (key["sr"], key["bucket"], key["rows"]) == (SR, 16000, 8)
    assert key["arch"] == "SpectralFallbackEncoder"
    base = tok._graph_key(SR, (8, 16000), False)
    assert tok._graph_key(SR, (4, 16000), False) != base
    assert tok._graph_key(SR, (8, 32000), False) != base
    assert tok._graph_key(22050, (8, 16000), False) != base
    assert tok._graph_key(SR, (8, 16000), True) != base
    tok.row_invariant = False
    assert tok._graph_key(SR, (8, 16000), False) != base
    tok.row_invariant = True
    saved = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = not saved
        assert tok._graph_key(SR, (8, 16000), False) != base
    finally:
        torch.backends.cudnn.deterministic = saved
    assert tok._graph_key(SR, (8, 16000), False) == base


def _forward(tok, wave):
    out = tok.forward(torch.from_numpy(wave), SR)
    return {k: out[k] for k in ("semantic_codes", "acoustic_codes",
                                "semantic_features")}


def test_eager_first_captured_second_replayed_after(graphs_on):
    """Sight 1 runs eagerly, sight 2 captures and replays, sight 3
    replays; every run gives the eager run's outputs, and each replay adds
    the graph's recorded K1 launches to the count."""
    tok = _graphed(_tokenizer())
    wave = _wave(rows=2)
    stats = tok._graphs.stats
    rvq_kernel.launches = 0
    ref = _forward(tok, wave)
    assert stats == dict(captures=0, replays=0, eager=1, failed=0,
                         invalidations=0, samples=2 * SR)
    assert rvq_kernel.launches == 0         # the plain chain launches none
    for sight in (2, 3):
        out = _forward(tok, wave)
        assert stats["captures"] == 1 and stats["replays"] == sight - 1
        assert rvq_kernel.launches == 2 * (sight - 1)
        for k, v in ref.items():
            assert torch.equal(v, out[k]), k
    other = _wave(seconds=2.0, rows=2)
    _forward(tok, other)                    # another key: eager again
    assert stats["eager"] == 2 and len(tok._graphs.graphs) == 1


@pytest.mark.parametrize("group", ["", "16"])
def test_forwards_wider_than_a_span_group_run_eagerly(graphs_on, monkeypatch,
                                                      group):
    """A batch of more rows than ``_graph_rows`` (a span group's, at least
    8) is never captured: every sight runs eagerly and gives the same
    outputs; at the cap it captures at its second sight."""
    monkeypatch.setenv("NAT_TPU_STREAM_GROUP", group)
    tok = _graphed(_tokenizer())
    cap = tok._graph_rows()
    assert cap == max(8, int(group or 1))
    stats = tok._graphs.stats
    wide = _wave(seconds=0.25, rows=cap + 1)
    ref = _forward(tok, wide)
    for _ in range(2):
        out = _forward(tok, wide)
        for k, v in ref.items():
            assert torch.equal(v, out[k]), k
    assert stats["eager"] == 3 and stats["captures"] == 0
    assert not tok._graphs.graphs
    at_cap = _wave(seconds=0.25, rows=cap)
    for _ in range(2):
        _forward(tok, at_cap)
    assert stats["captures"] == 1 and stats["replays"] == 1


def test_a_thread_captures_only_keys_it_has_run(graphs_on):
    """A capture records the calling thread's cuDNN and cuBLAS handles, so
    a thread runs a key eagerly once before it captures it (a daemon's
    prewarm thread after another thread's graph was dropped); a graph
    captured by one thread replays in any."""
    tok = _graphed(_tokenizer())
    wave = _wave()
    ref = _forward(tok, wave)
    _forward(tok, wave)                     # captured in this thread
    stats = tok._graphs.stats
    seen = []

    def other_thread():
        seen.append(dict(stats))
        out = _forward(tok, wave)           # replays this thread's graph
        seen.append(dict(stats))
        tok._graphs.invalidate()
        _forward(tok, wave)                 # not run here: eager first
        seen.append(dict(stats))
        out = _forward(tok, wave)           # then captured here
        seen.append(dict(stats))
        assert torch.equal(out["semantic_codes"], ref["semantic_codes"])

    worker = threading.Thread(target=other_thread)
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and len(seen) == 4
    steps = [(b["captures"] - a["captures"], b["replays"] - a["replays"],
              b["eager"] - a["eager"]) for a, b in zip(seen, seen[1:])]
    assert steps == [(0, 1, 0), (0, 0, 1), (1, 1, 0)]


def test_replay_outputs_are_copies(graphs_on):
    """A replay's outputs are copied out before the graph runs again: what
    an earlier caller holds (two items stay in flight) is not overwritten
    by the next span's replay, and each output equals its eager run's."""
    tok = _graphed(_tokenizer())
    a, b = _wave(seed=1), _wave(seed=2)
    eager_a, eager_b = _forward(tok, a), _forward(tok, b)
    out_a = _forward(tok, a)                # captured and replayed
    held = {k: v.clone() for k, v in out_a.items()}
    out_b = _forward(tok, b)                # replayed on other inputs
    for k in held:
        assert torch.equal(out_a[k], held[k]) and torch.equal(held[k],
                                                               eager_a[k])
        assert torch.equal(out_b[k], eager_b[k])
    static = tok._graphs.graphs[next(iter(tok._graphs.graphs))].static_outputs
    assert static["semantic_codes"].data_ptr() not in (
        out_a["semantic_codes"].data_ptr(), out_b["semantic_codes"].data_ptr())


def test_stochastic_seeds_reach_every_replay(graphs_on):
    """K2's seeds go through the graph's static seed buffer: replays
    sample with each span's own seeds, as eager runs do."""
    kw = dict(stochastic=True, temperature=0.5)
    eager, graphed = _tokenizer(**kw), _graphed(_tokenizer(**kw))
    wave = _wave(rows=1)
    for i in range(3):
        a, b = _forward(eager, wave), _forward(graphed, wave)
        for k in a:
            assert torch.equal(a[k], b[k]), (i, k)
    assert graphed._graphs.stats["replays"] == 2
    assert not torch.equal(a["semantic_codes"], _forward(eager,
                                                         wave)["semantic_codes"])


def _codebooks(tok, shift):
    rng = np.random.default_rng(shift)
    shape = (tok.num_semantic_layers, tok.codebook_size, tok.semantic_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _replace_codebooks(tok, how, tmp_path):
    """Replace the codebooks (and with them, where the place does, the
    weights) through one of the places that may, on ``tok``."""
    if how == "set_codebooks":
        tok._set_codebooks(*_codebooks(tok, 5))
    elif how == "rvq_attribute":
        from nat_tpu_torch.quant.rvq import RVQState

        tok.sem_rvq = RVQState.from_codebook(torch.from_numpy(
            _codebooks(tok, 6)[0]))
    elif how == "load_float_params":
        params = tok.float_params()
        tok.load_float_params({n: {k: v * 1.5 for k, v in sd.items()}
                               for n, sd in params.items()})
    elif how == "load_model":
        other = _tokenizer(seed=9)
        other.ensure_initialized()
        save_model(str(tmp_path / "m.pt"), other)
        assert load_model(str(tmp_path / "m.pt"), tok)
    elif how == "bridge":
        donor = _tokenizer(seed=11)
        donor.ensure_initialized()
        params = bridge.flax_params(donor.float_params(), 4)
        bridge.load_into_tokenizer(tok, params, *_codebooks(tok, 7))
    elif how == "trainer":
        from nat_tpu_torch.runtime.trainer import Trainer

        trainer = Trainer(tok)
        with torch.no_grad():
            for p in trainer.state.params.parameters():
                p.mul_(0.5)
        trainer.state.sem_rvq.codebook.mul_(-1.0)
        trainer.apply_to_tokenizer()
    elif how == "seed_from_audio":
        tok.maybe_seed_from_audio(_wave(seconds=2.0, seed=4)[0], SR)
    else:
        raise AssertionError(how)


@pytest.mark.parametrize("how", ["set_codebooks", "rvq_attribute",
                                 "load_float_params", "load_model", "bridge",
                                 "trainer", "seed_from_audio"])
def test_replacing_weights_or_codebooks_drops_the_graphs(graphs_on, how,
                                                         tmp_path):
    """Each place that replaces weights or codebooks drops the captured
    graphs; the next forward (captured anew) gives what an eager tokenizer
    with the same replacement gives, as the reference clears its
    ``_forward_cache``."""
    kw = dict(enable_reconstruction=how == "trainer",
              codebook_init_method=("kmeans" if how == "seed_from_audio"
                                    else "random"))
    tok, eager = _graphed(_tokenizer(**kw)), _tokenizer(**kw)
    wave = _wave()
    for _ in range(3):
        before = _forward(tok, wave)
    assert len(tok._graphs.graphs) == 1
    eager.ensure_initialized()
    for t in (tok, eager):
        torch.manual_seed(0)
        _replace_codebooks(t, how, tmp_path)
    assert not tok._graphs.graphs and tok._graphs.stats["invalidations"] >= 1
    after, expected = _forward(tok, wave), _forward(eager, wave)
    assert tok._graphs.stats["captures"] == 2      # the seen key, anew
    for k in after:
        assert torch.equal(after[k], expected[k]), k
    assert any(not torch.equal(before[k], after[k]) for k in after)


def test_a_failed_capture_warns_and_runs_eagerly(graphs_on, monkeypatch):
    messages = []
    monkeypatch.setattr(port_logging.logger, "warn", messages.append)

    def broken(fn, static_inputs, pool, stream):
        rvq_kernel._count("launches")
        raise RuntimeError("operation not permitted when stream is capturing")

    tok = _tokenizer()
    tok._graphs = aotcache.ForwardGraphs("cpu", capture=broken)
    wave = _wave()
    ref = _forward(tok, wave)
    rvq_kernel.launches = 0
    for _ in range(3):
        out = _forward(tok, wave)
        assert torch.equal(out["semantic_codes"], ref["semantic_codes"])
    stats = tok._graphs.stats
    assert stats["failed"] == 1 and stats["captures"] == 0
    assert stats["eager"] == 4 and rvq_kernel.launches == 0
    assert len(messages) == 1 and "capture" in messages[0] \
        and "RuntimeError" in messages[0] and "eagerly" in messages[0]


def test_prewarm_captures_each_shape_up_front(graphs_on):
    """Prewarming runs each shape twice with graphs on: the second run
    captures, so the first request replays; the span generator is left as
    it was."""
    tok = _graphed(_tokenizer(stochastic=True, temperature=0.5))
    tok.ensure_initialized()
    state = tok._span_seeds.get_state()
    done = prewarm_forwards(tok, SR, seconds=[1.0], rows=[1, 2])
    assert len(done) == 2 and len(tok._graphs.graphs) == 2
    assert tok._graphs.stats["captures"] == 2
    assert torch.equal(tok._span_seeds.get_state(), state)


def test_iter_chunks_through_graphs_gives_the_eager_frames(graphs_on):
    """The span loop (groups, lookahead, finalize) on graph replays: the
    same codes as eager, span by span, on a multi-span input."""
    wave = _wave(seconds=35.0, seed=3)[0]
    eager, graphed = _tokenizer(), _graphed(_tokenizer())
    for _ in range(2):
        a = eager(wave[None], SR, want_features=False, reconstruct=False)
        b = graphed(wave[None], SR, want_features=False, reconstruct=False)
        for key in ("semantic_codes", "acoustic_codes"):
            for x, y in zip(a[key], b[key]):
                np.testing.assert_array_equal(x, y)
    assert graphed._graphs.stats["replays"] > 0


def test_launch_tally_of_a_recording():
    """Launches inside ``recording`` go to its tally, not to the counts;
    ``add_launches`` adds a tally once per replay."""
    rvq_kernel.launches = rvq_kernel.sample_launches = 0
    with rvq_kernel.recording() as tally:
        rvq_kernel._count("launches")
        rvq_kernel._count("sample_launches")
        rvq_kernel._count("sample_launches")
    assert tally == {"launches": 1, "sample_launches": 2}
    assert (rvq_kernel.launches, rvq_kernel.sample_launches) == (0, 0)
    rvq_kernel.add_launches(tally)
    rvq_kernel.add_launches(tally)
    rvq_kernel._count("launches")
    assert (rvq_kernel.launches, rvq_kernel.sample_launches) == (3, 4)


def test_device_seed_form_of_the_sampling_wrapper():
    """On the CPU a one-element int64 seed tensor samples as the int does
    (the plain chain); the kernel's address check refuses other seeds."""
    from nat_tpu_torch.quant.rvq import RVQState

    g = torch.Generator().manual_seed(0)
    state = RVQState.from_codebook(torch.randn(4, 64, 32, generator=g))
    x = torch.randn(2, 9, 32, generator=g)
    a = rvq_kernel.rvq_encode(state, x, True, temperature=0.5, seed=1234)
    b = rvq_kernel.rvq_encode(state, x, True, temperature=0.5,
                              seed=torch.tensor([1234]))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError):
        rvq_kernel._device_seed(torch.tensor([1.0]), torch.device("cpu"))
    with pytest.raises(ValueError):
        rvq_kernel._device_seed(torch.tensor([1, 2]), torch.device("cpu"))


# ---------------------------------------------------------------------------
# Utilities against the JAX package's
# ---------------------------------------------------------------------------

def _messages(err: str, prefix: str):
    out = []
    for line in err.splitlines():
        _, _, rest = line.partition("] ")
        level, _, msg = rest.partition(f" {prefix}: ")
        if msg:
            out.append((level, msg))
    return out


@pytest.fixture
def both_loggers(monkeypatch):
    for module in (jax_logging, port_logging):
        monkeypatch.setattr(module.logger, "level", module.logger.level)
        monkeypatch.setattr(module.logger, "default_mode",
                            module.logger.default_mode)


def _emit_all(module):
    log = module.logger
    log.debug("d")
    log.info("i")
    log.warn("w")
    log.error("e")
    log.progress("p")


def test_log_setters_emit_the_same_lines(both_loggers, capsys):
    """``set_log_level`` and ``set_default_mode`` select the same lines in
    both packages, level by level, and default mode silences both."""
    for level in ("DEBUG", "INFO", "WARN", "ERROR"):
        for default in (False, True):
            got = []
            for module, prefix in ((jax_logging, "nat"),
                                   (port_logging, "nat-torch")):
                module.set_log_level(module.LogLevel[level])
                module.set_default_mode(default)
                _emit_all(module)
                got.append(_messages(capsys.readouterr().err, prefix))
            assert got[0] == got[1], (level, default)
            assert (not got[0]) == default


def test_heartbeat_emits_the_same_lines(both_loggers, capsys):
    """With INFO on, the announcement and then "... still" ticks; with it
    off, no line and no thread (the quiet path stays free)."""
    got = []
    for module, hb, prefix in ((jax_logging, jax_heartbeat, "nat"),
                               (port_logging, port_heartbeat, "nat-torch")):
        module.set_log_level(module.LogLevel.INFO)
        module.set_default_mode(False)
        with hb.heartbeat("capturing", interval=0.05, announce="start"):
            time.sleep(0.12)
        got.append(_messages(capsys.readouterr().err, prefix)[:2])
    assert got[0] == got[1] == [("INFO", "start"), (
        "INFO", "... still capturing (0s elapsed)")]
    for module, hb, prefix in ((jax_logging, jax_heartbeat, "nat"),
                               (port_logging, port_heartbeat, "nat-torch")):
        module.set_log_level(module.LogLevel.WARN)
        threads = threading.active_count()
        with hb.heartbeat("capturing", interval=0.01):
            assert threading.active_count() == threads
            time.sleep(0.03)
        assert capsys.readouterr().err == ""


def test_progress_reports_the_same_lines(both_loggers, capsys,
                                         monkeypatch):
    got = []
    for module, prog, prefix in ((jax_logging, jax_progress, "nat"),
                                 (port_logging, progress, "nat-torch")):
        module.set_log_level(module.LogLevel.INFO)
        module.set_default_mode(False)
        monkeypatch.setattr(prog.time, "time", lambda: 100.0)
        rep = prog.ProgressReporter(4, "Spans", min_interval_s=0.0)
        rep.start_time = 90.0
        for step in (1, 2, 4):
            rep.update(step)
        rep.finish()
        got.append(_messages(capsys.readouterr().err, prefix))
    assert got[0] == got[1] and len(got[0]) == 4
    assert got[1][0] == ("INFO", "Spans: 1/4 (25.0%) ETA 30s")


def test_pipeline_regions_and_trace(tmp_path, monkeypatch, simple_wav):
    """``NAT_TPU_PROFILE`` starts a torch.profiler trace when a pipeline is
    built; the reference's region names time the run (``stage_timings``)
    and appear in the trace written at stop."""
    monkeypatch.setenv("NAT_TPU_PROFILE", str(tmp_path / "trace"))
    profiling.reset_timings()
    pipe = AudioTokenizationPipeline(model_config=PIPE_CONFIG, device="cpu",
                                     enable_codebook_cache=False,
                                     enable_reconstruction=False)
    try:
        _frames(pipe, simple_wav)
    finally:
        path = profiling.stop_trace()
    names = {"nat/load_audio", "nat/sha256", "nat/tokenize", "nat/serialize",
             "nat/evaluate", "nat/pcm16_wire", "nat/dispatch",
             "nat/device_get", "nat/file", "nat/begin", "nat/stage",
             "nat/finalize", "nat/finish", "nat/eval/tokens"}
    assert names <= set(profiling.stage_timings)
    assert path and os.path.dirname(path) == str(tmp_path / "trace")
    events = json.load(open(path))["traceEvents"]
    assert names <= {e.get("name") for e in events}
    assert profiling.stop_trace() is None


def test_memory_and_warmup_do_nothing_without_a_card():
    assert memory.live_buffer_bytes() is None
    memory.aggressive_cleanup()
    assert warmup.start_backend_warmup("cpu") is None
    warmup.wait_for_warmup(0.1)
