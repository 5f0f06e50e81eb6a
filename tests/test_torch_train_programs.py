"""The training programs (Trainer.train_step, eval_step and recon_step on
utils/programs.py) on the CPU, at the tiny config of
tests/test_torch_train.py, through a stand-in capture backend that behaves
as a CUDA graph does wherever the CPU can show it:

  - its capture executes nothing: it runs the step (the Python around a
    capture runs) and then puts every tensor of the state back, values and
    versions;
  - its replay runs the step again on the static inputs with the launch
    counters off, copies the results into the static outputs and puts the
    versions back (a replay writes in place without bumping them); it
    refuses a state whose tensors are no longer at the capture's addresses
    (a replay writes where the capture wrote).

Captured steps that cross disc_start equal eager ones exactly, with one
program per side; replayed steps leave the version-keyed caches (the
codec's programs, the weight packs) seeing the new weights; a state loaded
with load_state_dict captures anew; a failed capture raises."""
import copy

import numpy as np
import pytest
import torch

from control_gic_tpu_torch.codec import CGICCodec
from control_gic_tpu_torch.kernels import build
from control_gic_tpu_torch.models import CGICConfig
from control_gic_tpu_torch.models import blocks
from control_gic_tpu_torch.ops import attention
from control_gic_tpu_torch.ops import norm_conv as tnc
from control_gic_tpu_torch.train import TrainConfig, Trainer, create_train_state
from control_gic_tpu_torch.train.losses import LossConfig

torch.set_num_threads(2)

TINY = dict(n_embed=32, embed_dim=4, z_channels=4, ch=32,
            ch_mult=(1, 1, 2, 2, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=64)
STEPS = 4
OPTIONS = {"default": ({}, {}),
           "remat_adaptive": ({"remat": True}, {"adaptive_g_weight": True})}


def _state_tensors(state):
    """Every tensor of the state, in a fixed order."""
    opt = [t for o in (state.opt_gen, state.opt_disc)
           for st in o.state.values() for t in st.values()
           if torch.is_tensor(t)]
    return [*state.gen.parameters(), *state.gen.buffers(),
            *state.disc.parameters(), *state.disc.buffers(),
            *state.lpips.parameters(), *state.lpips.buffers(), *opt,
            *state.ema.values(), state.codebook_counts]


def _set_versions(tensors, versions):
    torch._C._autograd._unsafe_set_version_counter(tuple(tensors),
                                                   tuple(versions))


class GraphLike:
    """The stand-in capture backend (see the module docstring)."""

    def __init__(self, state):
        self.state = state
        self.captures = self.replays = 0

    def capture(self, fn, inputs):
        tensors = _state_tensors(self.state)
        values = [t.detach().clone() for t in tensors]
        versions = [t._version for t in tensors]
        out = fn(*inputs)
        with torch.no_grad():
            for t, v in zip(tensors, values):
                t.copy_(v)
        _set_versions(tensors, versions)
        self.captures += 1
        return (fn, inputs, out, [t.data_ptr() for t in tensors]), out

    def replay(self, graph):
        fn, inputs, out, ptrs = graph
        tensors = _state_tensors(self.state)
        if [t.data_ptr() for t in tensors] != ptrs:
            raise AssertionError("a replay on tensors that moved since the "
                                 "capture")
        versions = [t._version for t in tensors]
        count = build.count_launch
        build.count_launch = lambda counts, key: None
        try:
            new = fn(*inputs)
        finally:
            build.count_launch = count
        pairs = ([(out, new)] if isinstance(out, torch.Tensor)
                 else zip(out.values(), new.values())
                 if isinstance(out, dict) else zip(out, new))
        for o, n in pairs:
            o.copy_(n)
        _set_versions(tensors, versions)
        self.replays += 1


class FailingCapture(GraphLike):
    def capture(self, fn, inputs):
        raise RuntimeError("operation not permitted when stream is capturing")


def _cfgs(option: str):
    model, loss = OPTIONS[option]
    return (CGICConfig(**TINY, **model),
            TrainConfig(loss=LossConfig(disc_start=2, **loss)))


@pytest.fixture(scope="module")
def fresh():
    """A fresh state for each option, and the batches."""
    states = {o: create_train_state(*_cfgs(o), device="cpu", seed=3)
              for o in OPTIONS}
    batches = np.random.default_rng(21).uniform(
        -1, 1, (STEPS, 2, 64, 64, 3)).astype(np.float32)
    return states, batches


def _trainers(option, state):
    """(captured trainer on a copy of state, its stand-in, eager trainer on
    another copy, the two states)."""
    cap_state, eager_state = copy.deepcopy(state), copy.deepcopy(state)
    captured = Trainer(*_cfgs(option))
    backend = GraphLike(cap_state)
    captured._programs_for(cap_state).backend = backend
    return captured, backend, cap_state, Trainer(*_cfgs(option)), eager_state


@pytest.fixture
def probe(monkeypatch):
    """Each attention call counts a flash_fwd launch and looks a value up
    twice in the weight-pack cache; records, per call, whether the value
    was made both times (no cache, as inside a training program)."""
    seen = []
    inner = blocks.attention
    key = torch.zeros(1)

    def counted(q, k, v):
        build.count_launch(attention.KERNEL_LAUNCHES, "flash_fwd")
        made = []
        for _ in range(2):
            tnc._cached((key,), ("probe",), lambda: made.append(1))
        seen.append(len(made) == 2)
        return inner(q, k, v)

    monkeypatch.setattr(blocks, "attention", counted)
    return seen


def _flash():
    return attention.KERNEL_LAUNCHES["flash_fwd"]


def _assert_states_equal(a, b):
    assert (a.step, a.ema_num_updates) == (b.step, b.ema_num_updates)
    for x, y in zip(_state_tensors(a), _state_tensors(b)):
        assert torch.equal(x, y)
    for oa, ob in ((a.opt_gen, b.opt_gen), (a.opt_disc, b.opt_disc)):
        assert len(oa.state) == len(ob.state) > 0


@pytest.mark.parametrize("option", list(OPTIONS))
def test_captured_steps_equal_eager_steps(fresh, probe, option):
    """Four steps over disc_start=2: params, Adam moments and steps, EMA,
    counters, batch stats, host counters and every metric exactly equal;
    one program per side of the switch, each captured once and replayed
    once; the same launches per step; weight packs made inside the
    programs."""
    states, batches = fresh
    captured, backend, cap_state, eager, eager_state = _trainers(
        option, states[option])
    for i, x in enumerate(batches):
        n0, k0 = _flash(), len(probe)
        cap_state, m_cap = captured.train_step(cap_state, x)
        n1, k1 = _flash(), len(probe)
        eager_state, m_eager = eager.train_step(eager_state, x)
        n2 = _flash()
        assert set(m_cap) == set(m_eager)
        for k in m_cap:
            assert torch.equal(m_cap[k], m_eager[k]), (i, k)
        assert n1 - n0 == n2 - n1 > 0, i
        _assert_states_equal(cap_state, eager_state)
        if i in (0, 2):      # a first call: the warm-up, then the capture
            assert all(probe[k0:k1]) and k1 > k0
    assert not any(probe[k1:])                     # eager: from the cache
    assert (backend.captures, backend.replays) == (2, 2)
    assert sorted(k[0] for k in captured._cache) == [("train", 0.0),
                                                     ("train", 1.0)]
    assert captured.program_stats()["programs_captured"] == 2


def test_eval_and_recon_programs_after_replayed_steps(fresh):
    """eval_step and recon_step programs, captured after two steps and
    replayed after two more, equal the eager steps on the same state."""
    states, batches = fresh
    captured, backend, cap_state, eager, eager_state = _trainers(
        "default", states["default"])
    for i, x in enumerate(batches):
        captured.train_step(cap_state, x)
        eager.train_step(eager_state, x)
        if i in (1, 3):
            for step in ("eval_step", "recon_step"):
                got = getattr(captured, step)(cap_state, batches[0])
                want = getattr(eager, step)(eager_state, batches[0])
                pairs = (zip(got.values(), want.values())
                         if isinstance(got, dict) else zip(got, want))
                assert all(torch.equal(a, b) for a, b in pairs), (i, step)
    assert (backend.captures, backend.replays) == (4, 4)


def test_replayed_steps_bump_versions(fresh):
    """After replayed steps, which write without bumping versions, the
    trainer has bumped them: a codec built on the generator captures anew
    (its programs are keyed on the weights' versions) and decodes with the
    new weights, and the weight-pack cache makes a new value."""
    states, batches = fresh
    captured, backend, state, _, _ = _trainers("default", states["default"])
    captured.train_step(state, batches[0])       # the warm-up and capture
    codec = CGICCodec(state.gen, np.ones(TINY["n_embed"], np.int64),
                      device="cpu")
    codec._programs.backend = GraphLike(state)
    img = (batches[0, 0] + 1) / 2
    codec.compress(img, 0.1, 0.4)
    w = state.gen.decoder.conv_out.weight
    pack = lambda: tnc._cached((w,), ("probe",), lambda: w.detach().clone())
    before = pack()
    versions = [t._version for t in state.written_tensors()]
    captured.train_step(state, batches[1])       # a replay
    assert backend.replays == 1
    assert all(t._version > v for t, v in
               zip(state.written_tensors(), versions))
    assert not torch.equal(before, w) and torch.equal(pack(), w)
    got = codec.compress(img, 0.1, 0.4)
    assert codec._programs.backend.captures == 4          # 2 + 2 anew
    eager = CGICCodec(copy.deepcopy(state.gen),
                      np.ones(TINY["n_embed"], np.int64), device="cpu",
                      graphs=False)
    want = eager.compress(img, 0.1, 0.4)
    assert got[2].streams == want[2].streams
    np.testing.assert_array_equal(got[0], want[0])


def test_load_state_dict_captures_anew(fresh):
    """torch.optim.Adam.load_state_dict replaces its state tensors: the next
    step captures anew rather than replay onto the old ones (the stand-in
    refuses such a replay), and equals an eager step from the same load."""
    states, batches = fresh
    captured, backend, cap_state, eager, eager_state = _trainers(
        "default", states["default"])
    for x in batches[:2]:
        captured.train_step(cap_state, x)
        eager.train_step(eager_state, x)
    other = copy.deepcopy(states["default"])
    Trainer(*_cfgs("default")).train_step(other, batches[3])
    saved = copy.deepcopy(other.state_dict())
    cap_state.load_state_dict(copy.deepcopy(saved))
    eager_state.load_state_dict(copy.deepcopy(saved))
    assert (backend.captures, backend.replays) == (1, 1)
    for x in batches[[2, 3, 0]]:     # steps 1 (off), 2 and 3 (on)
        _, m_cap = captured.train_step(cap_state, x)
        _, m_eager = eager.train_step(eager_state, x)
        assert all(torch.equal(m_cap[k], m_eager[k]) for k in m_cap)
    assert (backend.captures, backend.replays) == (3, 2)
    _assert_states_equal(cap_state, eager_state)


def test_failed_capture_raises(fresh):
    """No fallback to eager: a capture that fails makes the step raise,
    keeps no program and advances no host counter; so does eval_step."""
    states, batches = fresh
    state = copy.deepcopy(states["default"])
    trainer = Trainer(*_cfgs("default"))
    trainer._programs_for(state).backend = FailingCapture(state)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            trainer.train_step(state, batches[0])
        assert (state.step, state.ema_num_updates) == (0, 0)
        with pytest.raises(RuntimeError, match="capturing"):
            trainer.eval_step(state, batches[0])
        assert not trainer._cache


@pytest.mark.parametrize("graphs", [None, True, False])
def test_cpu_trainer_runs_eagerly(fresh, graphs):
    """A state on the CPU makes no graph (the caller asked for the CPU)."""
    states, batches = fresh
    state = copy.deepcopy(states["default"])
    trainer = Trainer(*_cfgs("default"), graphs=graphs)
    trainer.train_step(state, batches[0])
    assert trainer._programs_for(state).backend is None
    assert not trainer._cache and not trainer.program_stats()


def test_algorithm_flags_capture_anew(fresh):
    """A capture bakes in PyTorch's algorithm choice: under deterministic
    algorithms the same step key captures a program of its own."""
    states, batches = fresh
    captured, backend, state, _, _ = _trainers("default", states["default"])
    captured.train_step(state, batches[0])
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        captured.train_step(state, batches[1])
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])
    assert (backend.captures, backend.replays) == (2, 0)
    keys = list(captured._cache)
    assert keys[0][0] == keys[1][0] == ("train", 0.0)
    assert keys[0][2] != keys[1][2]
