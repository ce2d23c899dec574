"""A run with the timed path broken underneath comes out not correct (the
look for a card skipped, everything else as a run does it, at a tiny size
on the CPU, under the cells' own limits); a sound run comes out correct.
On a card, the controls at the cells' own sizes fail the limits
(``-m card``)."""

import pytest
import torch

from port_bench import run as R

SEED = 2 ** 31 + 11


def _token_altered(system):
    V = system.sampler_config.d_codebook
    fn = system.generate_tokens

    def altered(*a, **kw):
        seq = fn(*a, **kw)
        return torch.where(seq < V, (seq + 1) % V, seq)
    system.generate_tokens = altered


def _half_batch(system):
    fn = system.generate_tokens

    def half(cond_seq, gen_seq, *a, **kw):
        n = gen_seq.shape[0] // 2
        B = gen_seq.shape[0]
        cond = torch.cat([cond_seq[:n], cond_seq[B:B + n]]) if cond_seq.shape[0] == 2 * B \
            else cond_seq[:n]
        seq = fn(cond, gen_seq[:n], *a, **kw)
        return torch.cat([seq, seq])
    system.generate_tokens = half


def _state_unchanged(system):
    """The decode step never writes its K/V into the cache."""
    system.sampler.commit_rows = lambda cache, rows, row: None


def _train_unchanged(system, step):
    def same(state, batch, generator=None, clock=None):
        saved = {k: v.detach().clone() for k, v in state.params.items()}
        state, m = step(state, batch, generator, clock)
        with torch.no_grad():
            for k, v in state.params.items():
                v.copy_(saved[k])
        return state, m
    return same


def _faults():
    from port_bench.traffic import train

    gen = {"token_altered": _token_altered, "half_batch": _half_batch,
           "state_unchanged": _state_unchanged}
    return ([(c, n, f) for c in ("gen_feats_b512", "gen_frames_b512")
             for n, f in gen.items()]
            + [("train_b48", n, f) for n, f in train.FAULTS.items()]
            + [("train_b48", "state_unchanged", _train_unchanged)])


@pytest.mark.parametrize("cell,name,fault", _faults(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_fault_is_not_correct(tiny_tree, cell, name, fault):
    out = R.run_cell(tiny_tree, cell, SEED, 0.0, 0, device="cpu", patch=fault)
    assert out["result"]["correct"] is False, out["result"]["checks"]


@pytest.mark.parametrize("cell", ["gen_feats_b512", "gen_frames_b512", "train_b48"])
def test_sound_run_is_correct(tiny_tree, cell):
    out = R.run_cell(tiny_tree, cell, SEED, 0.0, 0, device="cpu")
    assert out["result"]["correct"] is True, out["result"]["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell,control", [
    ("gen_feats_b512", "int8_weights"), ("gen_feats_b512", "int4_cache"),
    ("gen_feats_b512", "bf16_codec"), ("gen_frames_b512", "int8_weights"),
    ("gen_frames_b512", "int8_encoder"), ("train_b48", "bf16_codec"),
    ("train_b48", "fp8_reference")])
def test_control_fails_at_the_cells_size(cell, control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import importlib

    from tiny import REPO

    c = R.load_cell(REPO, cell)
    kind = importlib.import_module(f"port_bench.traffic.{c['mix']['kind']}")
    readings = kind.calibration_run(c, control, SEED, torch.device("cuda", 0))
    ok, checks = __import__("port_bench.check", fromlist=["verdict"]).verdict(
        {**{k: 0.0 for k in c["limits"]}, **readings}, c["limits"], True)
    assert not ok, checks
