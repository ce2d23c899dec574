"""Serving graphs exported with ``torch.export``.

Counterpart of ``vaura_tpu/utils/aot.py``. The server's whole features ->
audio pipeline is traced once and written as serialized ATen graphs, with
the weights outside them (runtime arguments), so one artifact serves every
checkpoint of the same architecture, and a process that loads it needs
neither the model code nor the config: ``load_generate`` imports torch, the
registered decode-attention operator (``kernels/ops.py``) and the sampling
noise, never ``vaura_tpu_torch.models``.

JAX exports one program, a ``lax.scan`` over the steps. Here the artifact
holds three, each traced with the state as an input
(``torch.func.functional_call``):

* ``prologue(sampler state, feats) -> (cond_seq, gen_seq, valid_mask,
  *cache)``: the conditioning (with the CFG null stream), the pattern's
  initial sequence, its validity mask and a zero cache;
* ``step(sampler state, cond_seq, gen_seq, valid_mask, *cache, s[, noise])
  -> (column, *rows)``: ``VauraSystem.step_rows``, the device-position
  generation step (``s`` a 0-d int64 tensor), which writes nothing;
* ``epilogue(dac state, gen_seq) -> (audio, codes)``: the pattern reverted,
  then DAC ``from_codes`` and the decoder, in ``dac_chunk_size`` slices.

The loop over steps is a short host loop here (``_drive``): for each step it
draws the sampling's uniform noise from a ``torch.Generator`` seeded with
the request's seed, with the call and shape ``ops/sampling.py`` makes, runs
the step, and writes the column and the cache rows it returns. So the codes
equal ``VauraSystem.generate``'s for the same seed. Nothing is compiled: the
loaded programs run as ``GraphModule``s, operator by operator, the same
launches the eager path makes (no ``torch.compile``, Inductor, AOTInductor or
CUDA graph).

Artifact layout: ``<path>`` is a zip of the three programs
(``torch.export.save`` each) and ``contract.json`` (the loop's: the state
names each program takes, the steps, the noise's shape, the cache rows a
step returns); ``<path>.json`` records the JAX package's input contract
(``batch``, ``tv``, ``cond_dim``, ``max_new_tokens``, ``tokens_per_frame``,
``decode_buckets``, ``dac_chunk_size``, ``sampling`` as strings,
``sample_rate``) and, where JAX records ``platforms``, the ``device`` type
the programs were traced on and its name. Loading for another device type
raises ``ValueError``.
"""

from __future__ import annotations

import inspect
import io
import itertools
import json
import zipfile
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

# registers torch.ops.vaura_torch.decode_attention, which the step calls
from vaura_tpu_torch.kernels import ops as _registered  # noqa: F401
from vaura_tpu_torch.ops.sampling import draws_noise, uniform_noise
from vaura_tpu_torch.utils import DeviceLike, resolve_device

PROGRAMS = ("prologue", "step", "epilogue")
# the state each program takes: the names under these modules of the system
STATE_OF = {"prologue": "sampler.", "step": "sampler.", "epilogue": "dac."}
SAMPLING_KEYS = ("use_sampling", "temp", "top_k", "top_p", "cfg_scale")


def serving_state(system) -> Dict[str, torch.Tensor]:
    """The tensors the programs take, under their names in ``system``: the
    sampler's and the codec's parameters and buffers; a LoRA system's
    adapted weights merged, as ``lora_merged`` installs them for a
    generation."""
    state = {}
    for top in ("sampler", "dac"):
        module = getattr(system, top)
        for name, t in itertools.chain(module.named_parameters(),
                                       module.named_buffers()):
            state[f"{top}.{name}"] = t.detach()
    if system.lora_sampler is not None:
        from vaura_tpu_torch.train.lora import merge_lora

        with torch.no_grad():
            merged = merge_lora(system.sampler, system.lora_sampler,
                                system.lora_alpha)
        state.update({f"sampler.{name}.weight": w
                      for name, w in merged.items()})
    return state


class _Call(nn.Module):
    """``fn(system, *args)`` as a module's forward, for
    ``functional_call``."""

    def __init__(self, system, fn):
        super().__init__()
        self.system = system
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.system, *args)


class _Program(nn.Module):
    """What ``torch.export`` traces: ``forward(state, *args)`` runs
    ``fn(system, *args)`` with ``state`` in place of the system's tensors.
    The system is not a registered child, so none of its tensors is
    lifted into the program: the state comes in at every call."""

    def __init__(self, system, fn):
        super().__init__()
        self._call = [_Call(system, fn)]

    def forward(self, state, *args):
        return torch.func.functional_call(
            self._call[0], {f"system.{k}": v for k, v in state.items()},
            args)


def _cache_names(system) -> list:
    cfg = system.sampler_config
    if cfg.deepseek:
        raise NotImplementedError(
            "exporting the DeepSeek-V3 block: its decode kernels have no "
            "registered operator")
    names = ["k", "v"] + (["k_scale", "v_scale"] if cfg.quantize_cache else [])
    return names + (["chunk_starts"] if system._quantizes_probs() else [])


def _programs(system, *, max_new_tokens, tokens_per_frame, sampling,
              decode_buckets, dac_chunk_size):
    """The three functions of ``(system, *args)`` that are exported."""
    from vaura_tpu_torch.models.vaura import UNKNOWN_TOKEN, chunk_bounds

    names = _cache_names(system)
    n_rows = 4 if system.sampler_config.quantize_cache else 2
    use_cfg = sampling["cfg_scale"] > 1.0

    def prologue(system, feats):
        pattern, valid_mask, S = system.prepare_generation(max_new_tokens)
        dev = feats.device
        codes = torch.full((feats.shape[0], system.num_codebooks,
                            max_new_tokens), UNKNOWN_TOKEN, dtype=torch.long,
                           device=dev)
        gen_seq, _, _ = pattern.build_pattern_sequence(
            codes, system.special_token_id)
        cond_seq = system.build_cond_seq_for_generation(
            feats, S, tokens_per_frame, cfg=use_cfg)
        cache = system.sampler.init_cache(cond_seq.shape[0], S)
        if system._quantizes_probs():
            cache["chunk_starts"] = torch.tensor(
                chunk_bounds(S, decode_buckets, 1)[:-1], dtype=torch.int32,
                device=dev)
        return (cond_seq, gen_seq, torch.as_tensor(valid_mask, device=dev),
                *(cache[n] for n in names))

    def step(system, cond_seq, gen_seq, valid_mask, *rest):
        cache = dict(zip(names, rest))
        s, noise = rest[len(names)], rest[len(names) + 1:]
        col, rows = system.step_rows(cache, gen_seq, cond_seq, s, valid_mask,
                                     noise=noise[0] if noise else None,
                                     **sampling)
        return (col, *(rows[n] for n in names[:n_rows]))

    def epilogue(system, gen_seq):
        pattern = system.pattern_provider.get_pattern(max_new_tokens)
        codes, _, _ = pattern.revert_pattern_sequence(gen_seq, UNKNOWN_TOKEN)
        codes = codes[..., :max_new_tokens]
        return system.decode_audio(codes, chunk_size=dac_chunk_size), codes

    return {"prologue": prologue, "step": step, "epilogue": epilogue}, n_rows


def export_generate(
    system,
    state: Optional[Dict[str, torch.Tensor]] = None,
    *,
    batch: int,
    tv: int,
    max_new_tokens: int,
    path: str | Path,
    tokens_per_frame: int = 7,
    sampling: Optional[Dict[str, Any]] = None,
    decode_buckets: int = 8,
    dac_chunk_size: Optional[int] = None,
) -> Dict[str, Any]:
    """Export ``system.generate`` (features -> audio + codes) as the
    artifact at ``path``, traced on the system's device with ``state``
    (default ``serving_state(system)``) as its example weights.

    The loaded callable has signature ``(state, feats[batch, tv, cond_dim]
    float32, seed: int) -> (audio, codes)``. Returns the metadata dict (also
    written to ``<path>.json``). Raises ``ValueError`` for a system placed
    on a mesh (the programs are single-device)."""
    if system.placement is not None:
        raise ValueError("export_generate: a system placed on a mesh; the "
                         "exported programs are single-device")
    state = serving_state(system) if state is None else state
    sampling = dict(sampling or {})
    defaults = inspect.signature(type(system).generate).parameters
    resolved = {**{k: defaults[k].default for k in SAMPLING_KEYS},
                **sampling}  # generate's defaults
    fns, n_rows = _programs(
        system, max_new_tokens=max_new_tokens,
        tokens_per_frame=tokens_per_frame, sampling=resolved,
        decode_buckets=decode_buckets, dac_chunk_size=dac_chunk_size)
    dev = system.device
    cfg = system.sampler_config
    feats = torch.zeros(batch, tv, cfg.cond_in_dim, device=dev)
    parts = {name: {k: v for k, v in state.items() if k.startswith(prefix)}
             for name, prefix in STATE_OF.items()}
    noise_shape = ([batch, cfg.num_codebooks, cfg.d_codebook]
                   if draws_noise(resolved["use_sampling"], resolved["temp"])
                   else None)
    with torch.no_grad():
        # the prologue's outputs are the step's and the epilogue's example
        # inputs
        first = fns["prologue"](system, feats)
        s = torch.ones((), dtype=torch.long, device=dev)
        noise = (() if noise_shape is None else
                 (torch.zeros(noise_shape, device=dev),))
        example = {"prologue": (feats,), "step": (*first, s, *noise),
                   "epilogue": (first[1],)}
        programs = {}
        for name in PROGRAMS:
            ep = torch.export.export(
                _Program(system, fns[name]), (parts[name], *example[name]),
                strict=False)
            ep.example_inputs = None  # the state: never written
            programs[name] = ep
    contract = {
        "state_keys": {name: list(parts[name]) for name in PROGRAMS},
        "steps": int(first[1].shape[-1]),
        "noise_shape": noise_shape,
        "cache_rows": n_rows,
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for name, ep in programs.items():
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            zf.writestr(f"{name}.pt2", buf.getvalue())
        zf.writestr("contract.json", json.dumps(contract))
    meta = {
        "batch": batch,
        "tv": tv,
        "cond_dim": cfg.cond_in_dim,
        "max_new_tokens": max_new_tokens,
        "tokens_per_frame": tokens_per_frame,
        "decode_buckets": decode_buckets,
        "dac_chunk_size": dac_chunk_size,
        "sampling": {k: str(v) for k, v in sampling.items()},
        "device": dev.type,
        "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
        "sample_rate": int(system.dac.cfg.sample_rate),
    }
    Path(str(path) + ".json").write_text(json.dumps(meta, indent=1),
                                         encoding="utf-8")
    return meta


def _drive(programs, contract, state, feats, seed, device):
    """Run the loaded programs for one batch: the prologue, one step a
    sequence position (noise drawn here, column and rows written here), the
    epilogue."""
    parts = {}
    for name, keys in contract["state_keys"].items():
        missing = [k for k in keys if k not in state]
        if missing:
            raise ValueError(f"the state lacks {len(missing)} tensors the "
                             f"{name} program takes, e.g. {missing[0]!r}")
        parts[name] = {k: state[k] for k in keys}
    generator = torch.Generator(device).manual_seed(int(seed))
    cond_seq, gen_seq, valid_mask, *cache = programs["prologue"](
        parts["prologue"], feats)
    noise_shape = contract["noise_shape"]
    positions = torch.arange(contract["steps"], device=device)
    step, n_rows = programs["step"], contract["cache_rows"]
    for s in range(1, contract["steps"]):
        noise = (() if noise_shape is None else
                 (uniform_noise(noise_shape, generator, device),))
        col, *rows = step(parts["step"], cond_seq, gen_seq, valid_mask,
                          *cache, positions[s], *noise)
        for buf, row in zip(cache[:n_rows], rows):
            buf[:, :, s - 1] = row
        gen_seq[:, :, s] = col
    audio, codes = programs["epilogue"](parts["epilogue"], gen_seq)
    return audio, codes


def _runnable(ep) -> nn.Module:
    """The program as a module to call. Two kinds of checks that cost host
    time at every step and compute nothing go: the module's check of every
    input against the exported shapes (~1 ms a call for the state's few
    hundred tensors; the loop checks the features and the state's names
    once a call instead), and the graph's ``_assert_tensor_metadata`` nodes,
    which ``torch.export`` puts beside each ``.to(dtype)``."""
    module = ep.module()
    if hasattr(module, "validate_inputs"):
        module.validate_inputs = False
    asserts = [n for n in module.graph.nodes if n.op == "call_function"
               and n.target is torch.ops.aten._assert_tensor_metadata.default]
    for node in asserts:
        module.graph.erase_node(node)
    if asserts:
        module.recompile()
    return module


def load_generate(
    path: str | Path, device: DeviceLike = None,
) -> Tuple[Callable[..., Tuple[torch.Tensor, torch.Tensor]], Dict[str, Any]]:
    """Load an artifact written by :func:`export_generate` for ``device``
    (``cuda`` by default; it raises without CUDA unless ``cpu`` is asked
    for). Returns ``(fn, meta)`` where ``fn(state, feats, seed)`` runs the
    programs (``state`` the tensors of ``serving_state``, on the device;
    ``feats`` float32 ``[batch, tv, cond_dim]``; ``seed`` an int). An
    artifact traced for another device type, or features of another shape,
    dtype or device type, raise ``ValueError``."""
    device = resolve_device(device)
    path = Path(path)
    meta_path = Path(str(path) + ".json")
    meta = (json.loads(meta_path.read_text(encoding="utf-8"))
            if meta_path.exists() else {})
    traced = meta.get("device")
    if traced is not None and traced != device.type:
        raise ValueError(f"aot artifact {path} was traced for {traced!r} "
                         f"({meta.get('device_name')}); it does not load on "
                         f"{device.type!r}: re-export on this device type")
    with zipfile.ZipFile(path) as zf:
        contract = json.loads(zf.read("contract.json"))
        programs = {name: _runnable(torch.export.load(
                        io.BytesIO(zf.read(f"{name}.pt2"))))
                    for name in PROGRAMS}
    want = (meta.get("batch"), meta.get("tv"), meta.get("cond_dim"))

    def fn(state, feats, seed):
        if isinstance(feats, torch.Tensor) and feats.device.type != device.type:
            raise ValueError(f"features on {feats.device}, the artifact "
                             f"runs on {device.type}")
        feats = torch.as_tensor(feats, device=device)
        if feats.dtype != torch.float32 or (
                None not in want and tuple(feats.shape) != want):
            raise ValueError(f"features {tuple(feats.shape)} {feats.dtype} "
                             f"do not match the artifact's float32 {want}")
        with torch.no_grad():
            return _drive(programs, contract, state, feats, seed, device)

    return fn, meta
