"""The port's ``ModelExecutor`` on the dense-slot path against the JAX
``ModelExecutor`` for the recurrent archs, in f32 on bridged weights:
reduced jamba (Mamba + MoE, attention) and reduced xLSTM (mLSTM, sLSTM)
under the scripted schedule of tests/test_torch_executor.py (chunked
prefill, decode, one recompute-style preemption) emit identical token
streams. Prompts are whole chunks, so each JAX run compiles one prefill
and one decode shape. And a slot that served another request decodes the
same tokens as a fresh one."""
import pytest
from test_torch_executor import (CHUNK, PREEMPT_AT, VICTIM, TAlloc, _drive,
                                 _jax_tokens, _port, treq)

pytest.importorskip("jax")

SPECS = [(24, 5), (12, 4), (36, 4), (24, 3)]     # 16 tokens out


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m"])
def test_recurrent_executor_matches_jax_executor(arch):
    want = _jax_tokens(arch, "legacy", SPECS)
    ex = _port(arch=arch)
    assert ex.legacy and not ex.paged_ok      # recurrent state: dense slots
    got = _drive(ex, TAlloc, treq, SPECS, CHUNK, PREEMPT_AT, VICTIM)
    assert got == want
    assert [len(got[f"ex{i}"]) for i in range(len(SPECS))] == \
        [o for _, o in SPECS]
    assert ex.free_slots and not ex.slot_of


def _serve_one(ex, rid, prompt=20, out=6):
    """One request alone through the executor: prefill in one chunk, then
    decodes; its slot released at the end."""
    req = treq.Request(rid=rid, modality=treq.Modality.TEXT, arrival=0.0,
                       text_tokens=prompt, prompt_tokens=prompt,
                       output_tokens=out)
    ex.allocator.allocate(rid, prompt + out + 2)
    ex.run_iteration([(req, prompt)], [], [])
    req.prefilled, req.decoded = prompt, 1
    req.state = treq.State.RUNNING
    while req.decoded < out:
        ex.run_iteration([], [req], [])
        req.decoded += 1
    req.state = treq.State.FINISHED
    ex.allocator.free(rid)
    slot = ex.slot_of[rid]
    ex.release_slot(req)
    return ex.emitted[rid], slot


def test_reused_slot_decodes_like_a_fresh_one():
    """jamba: Mamba state (conv, ssm) and attention K/V in one slot. A
    released slot is zeroed in place, which is how a fresh one starts."""
    arch = "jamba-1.5-large-398b"
    fresh, _ = _serve_one(_port(arch=arch), "b")
    ex = _port(arch=arch)
    first, slot_a = _serve_one(ex, "a")
    reused, slot_b = _serve_one(ex, "b")     # the slot "a" released
    assert slot_a == slot_b and first != reused
    assert reused == fresh
