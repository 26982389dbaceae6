"""HuggingFace GPT-2 checkpoint names <-> the port's GPT-2 tree (the port
of the reference's ``models/hf_gpt2.py``, as the name mapper it is).

The reference starts from HuggingFace's pretrained ``GPT2DoubleHeadsModel``
(``--model_checkpoint``) and resizes the token embedding for the five
PersonaChat special tokens. Nothing is downloaded: a checkpoint directory
that holds a ``pytorch_model.bin`` is mapped in, otherwise the caller keeps
its fresh init. Only the directory named is read (the reference also looks
in the user's HuggingFace cache; the port reads nothing outside the paths
it is given).

Names (ours <- HF):
  transformer/wte, wpe            <- transformer.wte.weight, .wpe.weight
  transformer/h_i/ln_1, ln_2      <- ...h.i.ln_1.weight/.bias (scale/bias)
  transformer/h_i/attn/c_attn, c_proj, mlp/c_fc, mlp/c_proj
                                  <- HF Conv1D .weight [in, out] (== our
                                     Dense kernel) and .bias
  transformer/ln_f                <- transformer.ln_f.weight/.bias
The LM head is tied to wte on both sides; the MC head has no pretrained
counterpart and keeps its fresh init on load (``save_pretrained`` writes it
as ``multiple_choice_head.summary``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

_LINEARS = ("attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj")


def find_torch_checkpoint(model_checkpoint: str) -> Optional[str]:
    """``<model_checkpoint>/pytorch_model.bin`` if that file exists."""
    path = os.path.join(model_checkpoint, "pytorch_model.bin")
    return path if os.path.isfile(path) else None


def _hf_items(gcfg):
    """(our path in the transformer tree, HF name) of every mapped
    tensor."""
    yield ("wte",), "wte.weight"
    yield ("wpe",), "wpe.weight"
    for i in range(gcfg.n_layer):
        hf = f"h.{i}."
        for ln in ("ln_1", "ln_2"):
            yield (f"h_{i}", ln, "scale"), hf + ln + ".weight"
            yield (f"h_{i}", ln, "bias"), hf + ln + ".bias"
        for lin in _LINEARS:
            ours = (f"h_{i}",) + tuple(lin.split("."))
            yield ours + ("kernel",), hf + lin + ".weight"
            yield ours + ("bias",), hf + lin + ".bias"
    yield ("ln_f", "scale"), "ln_f.weight"
    yield ("ln_f", "bias"), "ln_f.bias"


def _node(tree, path):
    for k in path[:-1]:
        tree = tree[k]
    return tree


def map_state_dict(state_dict: Dict[str, torch.Tensor], gcfg,
                   params: Any) -> Any:
    """The tree ``params`` with every HF tensor of ``state_dict`` mapped
    in (a new tree; ``params`` is left as it was). Embedding rows past the
    checkpoint's vocabulary (the special tokens) keep ``params``' rows."""
    sd = {k.removeprefix("transformer."): v for k, v in state_dict.items()}

    def copy(node):
        return ({k: copy(v) for k, v in node.items()}
                if isinstance(node, dict) else node.clone())

    out = copy(params)
    tr = out["params"]["transformer"]
    for path, name in _hf_items(gcfg):
        theirs = sd[name].detach().to(torch.float32)
        node = _node(tr, path)
        ours = node[path[-1]]
        if path[0] in ("wte", "wpe"):
            n = min(ours.shape[0], theirs.shape[0])
            ours[:n] = theirs[:n].to(ours.device)
        else:
            if tuple(theirs.shape) != tuple(ours.shape):
                raise ValueError(f"{name}: checkpoint shape "
                                 f"{tuple(theirs.shape)}, model "
                                 f"{tuple(ours.shape)}")
            node[path[-1]] = theirs.to(ours.device)
    return out


def load_hf_gpt2_params(checkpoint: str, gcfg, params: Any, *,
                        seed: int = 0) -> Tuple[Any, bool]:
    """``(params, loaded)``: ``params`` with a local HF GPT-2 checkpoint
    mapped in when ``checkpoint`` holds one, else ``params`` unchanged.
    (``seed`` is the reference's argument; the fresh rows come from the
    caller's init.)"""
    path = find_torch_checkpoint(checkpoint)
    if path is None:
        return params, False
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return map_state_dict(sd, gcfg, params), True


def to_state_dict(gcfg, params: Any) -> Dict[str, torch.Tensor]:
    """The tree in HF ``GPT2DoubleHeadsModel`` names: ``transformer.*``,
    the tied ``lm_head.weight`` and ``multiple_choice_head.summary.*``."""
    tr = params["params"]["transformer"]
    sd = {"transformer." + name: _node(tr, path)[path[-1]].detach().cpu()
          .to(torch.float32).contiguous() for path, name in _hf_items(gcfg)}
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    mc = params["params"]["mc_head"]
    sd["multiple_choice_head.summary.weight"] = (
        mc["kernel"].detach().cpu().to(torch.float32).T.contiguous())
    sd["multiple_choice_head.summary.bias"] = (
        mc["bias"].detach().cpu().to(torch.float32).contiguous())
    return sd


def save_pretrained(out_dir: str, gcfg, params: Any) -> None:
    """An HF-style checkpoint directory in torch's own format:
    ``config.json`` and ``pytorch_model.bin`` (``to_state_dict``), which
    ``load_hf_gpt2_params`` reads back."""
    os.makedirs(out_dir, exist_ok=True)
    cfg = {k: v for k, v in dataclasses.asdict(gcfg).items() if k != "dtype"}
    cfg["model_type"] = "gpt2"
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    torch.save(to_state_dict(gcfg, params),
               os.path.join(out_dir, "pytorch_model.bin"))
