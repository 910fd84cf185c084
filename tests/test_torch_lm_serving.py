"""The port's LM serving engine against a greedy JAX loop, on the CPU.

``repro_torch.serve.ServingEngine`` (greedy, ``device="cpu"``) serves
requests of different prompt lengths and budgets in waves; a JAX loop over
``repro.models.transformer.lm_prefill`` / ``lm_decode_step`` replays each
wave on the same left-padded prompts and the port's own tokens (the
reference's ``ServingEngine.run`` cannot be driven here: on jax 0.9.0 it
fails after its first decode step, because ``lm_decode_step`` returns (B,
1, V) logits and ``int()`` refuses the (B, 1) argmax).  At every step the
port's token equals JAX's argmax, or JAX's top-2 logit gap is under the
tolerance: 2e-4 · max|logit| with f32 activations (the logits agree to
rtol 1e-4, ``tests/test_torch_lm.py``), 0.05 · max(max|logit|, 1) in bf16
(``tests/test_arch_smoke.py``'s tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget
from repro.models.params import init_params as jinit
from repro.models.transformer import (lm_decode_step as jdecode,
                                      lm_prefill as jprefill)
from repro_torch.configs import get_smoke_config as tget
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import Request, ServingEngine
from repro_torch.serve.engine import ServeStats

# (prompt length, max new tokens) per request; 2 slots -> 3 waves
REQUESTS = [(9, 5), (14, 3), (6, 6), (11, 6), (7, 4)]
SLOTS, MAX_LEN = 2, 20


class RecordingEngine(ServingEngine):
    """Keeps every wave's selected tokens (prefill, then each decode step)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.selected = []

    def _select(self, logits):
        cur = super()._select(logits)
        self.selected.append(cur.clone())
        return cur


def _setup(dtype, seed=0):
    jcfg = dataclasses.replace(jget("qwen2_0_5b"), activation_dtype=dtype)
    tcfg = dataclasses.replace(tget("qwen2_0_5b"), activation_dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        a = tree["blocks"]["attn"][name]
        tree["blocks"]["attn"][name] = (0.1 * rng.standard_normal(a.shape)
                                        ).astype(np.float32)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n, _ in REQUESTS]
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg,
            lm_params_from_numpy(tree, tcfg, device="cpu"), prompts)


def _requests(prompts):
    return [Request(prompt=p, max_new_tokens=m, id=i)
            for i, (p, (_, m)) in enumerate(zip(prompts, REQUESTS))]


def _gap_tol(logits, dtype):
    top = float(np.abs(logits).max())
    return 2e-4 * top if dtype == "float32" else 0.05 * max(top, 1.0)


def replay_waves_in_jax(engine, reqs, jcfg, jparams, dtype, slots,
                        max_len):
    """Replay each wave of ``engine.run(reqs)`` (a :class:`RecordingEngine`)
    through a greedy JAX loop on the same left-padded prompts and the
    port's own tokens.  At every step the port's token must equal JAX's
    argmax or JAX's top-2 gap be under :func:`_gap_tol`, and each
    request's output must equal the loop's.  Returns (tokens checked,
    tokens equal to JAX's argmax)."""
    selected = iter(engine.selected)
    checked = agreed = 0
    for w in range(0, len(reqs), slots):
        wave = reqs[w:w + slots]
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((len(wave), plen), np.int32)
        for i, r in enumerate(wave):
            toks[i, plen - len(r.prompt):] = r.prompt
        logits, cache = jprefill(jparams, jcfg, jnp.asarray(toks),
                                 cache_len=max_len)
        logits = np.asarray(logits[:, -1], np.float32)
        outputs = [[] for _ in wave]
        pos = plen
        while True:
            cur = next(selected).numpy()
            ref = logits.argmax(-1)
            top2 = np.sort(logits, -1)[:, -2:]
            tol = _gap_tol(logits, dtype)
            for i in range(len(wave)):
                checked += 1
                agreed += int(cur[i] == ref[i])
                assert cur[i] == ref[i] or top2[i, 1] - top2[i, 0] < tol, (
                    w, pos, i, cur[i], ref[i], top2[i], tol)
                if len(outputs[i]) < wave[i].max_new_tokens:
                    outputs[i].append(int(cur[i]))
            if all(len(o) >= r.max_new_tokens
                   for o, r in zip(outputs, wave)) or pos >= max_len - 1:
                break
            logits, cache = jdecode(jparams, jcfg, cache,
                                    jnp.asarray(cur[:, None]), jnp.int32(pos))
            logits = np.asarray(logits[:, -1], np.float32)
            pos += 1
        assert [r.output for r in wave] == outputs
    assert next(selected, None) is None
    assert all(r.done for r in reqs)
    return checked, agreed


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_serving_matches_a_jax_greedy_loop(dtype):
    jcfg, jparams, tcfg, tparams, prompts = _setup(dtype)
    engine = RecordingEngine(tcfg, tparams, batch_slots=SLOTS,
                             max_len=MAX_LEN, device="cpu")
    reqs = _requests(prompts)
    stats = engine.run(reqs)
    checked, agreed = replay_waves_in_jax(engine, reqs, jcfg, jparams, dtype,
                                          SLOTS, MAX_LEN)
    if dtype == "float32":
        assert agreed == checked
    # waves (prompt len, steps): (14, 4) stopped by budgets 5 and 3;
    # (11, 5) by budgets 6 and 6; (7, 3) by budget 4
    assert stats.steps == 4 + 5 + 3
    assert stats.tokens_out == sum(min(m, 6) for _, m in REQUESTS)
    assert stats.prefill_s > 0 and stats.decode_s > 0
    assert stats.tokens_per_s == stats.tokens_out / stats.decode_s


def test_serving_stops_at_max_len():
    """``pos >= max_len - 1`` ends a wave before the budgets do."""
    _, _, tcfg, tparams, prompts = _setup("float32")
    engine = ServingEngine(tcfg, tparams, batch_slots=4, max_len=16,
                           device="cpu")
    reqs = [Request(prompt=prompts[1], max_new_tokens=10),
            Request(prompt=prompts[2], max_new_tokens=10)]
    stats = engine.run(reqs)
    # prompt length 14: tokens at positions 14 and 15, one decode step
    assert stats.steps == 1 and [len(r.output) for r in reqs] == [2, 2]
    assert stats.tokens_out == 4


def test_sampling_is_seeded():
    _, _, tcfg, tparams, prompts = _setup("float32")
    outs = []
    for seed in (3, 3, 4):
        engine = ServingEngine(tcfg, tparams, batch_slots=SLOTS,
                               max_len=MAX_LEN, greedy=False, seed=seed,
                               device="cpu")
        reqs = _requests(prompts)
        engine.run(reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert all(0 <= t < tcfg.vocab_size for o in outs[2] for t in o)


def test_serve_stats_defaults():
    s = ServeStats()
    assert (s.steps, s.tokens_out, s.tokens_per_s) == (0, 0, 0.0)


def test_launch_serve_runs_on_the_cpu(capsys):
    stats = launch_serve.main(["--arch", "qwen2-0.5b", "--smoke",
                               "--device", "cpu", "--requests", "3",
                               "--prompt-len", "8", "--new-tokens", "3",
                               "--slots", "2", "--max-len", "16"])
    assert stats.tokens_out == 9 and stats.steps == 2 + 2
    assert "done: 3/3 requests, 9 tokens" in capsys.readouterr().out


def test_entry_points_need_a_device_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tcfg, tparams, _ = _setup("float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tcfg, tparams)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "qwen2_0_5b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_numpy({}, tcfg)
    with pytest.raises(ValueError, match="passes no encoder frames"):
        ServingEngine(tget("seamless_m4t_large_v2"), {}, device="cpu")
