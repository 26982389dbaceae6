"""The one generator of training traffic: a cell's traffic file (its
numbers only) and the seed give every client's samples. The same arrays
go to the program (through its dataset and sampler) and to the
reference (``benchmark/reference/sampler.py`` draws the same rounds).

* ``personachat``: PersonaChat-shaped dialogs, one persona a client. A
  sequence is ``<bos>`` persona, the history turns each after its
  speaker token, then ``<speaker2>`` candidate ``<eos>``, right-padded
  to ``max_seq_len``; the true candidate is last and only its reply
  carries LM labels; the distractors are replies of other dialogs. Each
  client's tokens come from its own band of the base vocabulary, so the
  true reply is distinguishable.
* ``cifar``: CIFAR-10-shaped uint8 NHWC images, a random prototype a
  class plus Gaussian noise, drawn on the device in one call each and
  copied to the host once; clients hold contiguous equal slices.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

IGNORE = -100
SPECIALS = ("<bos>", "<eos>", "<speaker1>", "<speaker2>", "<pad>")


def special_ids(base_vocab: int) -> Dict[str, int]:
    return {name: base_vocab + i for i, name in enumerate(SPECIALS)}


def personachat(tr: dict, base_vocab: int, seed: int
                ) -> Tuple[Dict[str, np.ndarray], List[np.ndarray]]:
    """``(arrays, client_indices)``: ``input_ids``, ``token_type_ids``,
    ``lm_labels`` ``[n, candidates, T]`` int32, ``mc_token_ids [n,
    candidates]`` and ``mc_labels [n]``, n = clients x dialogs."""
    rng = np.random.default_rng([int(seed), 1])
    C, N = tr["num_clients"], tr["dialogs_per_client"]
    K, T = tr["num_candidates"], tr["max_seq_len"]
    H = 2 * tr["max_history"] + 1
    Lp = tr["persona_sentences"] * tr["sentence_tokens"]
    Lt = tr["turn_tokens"]
    band = tr["token_band"]
    sp = special_ids(base_vocab)
    lo = rng.integers(0, base_vocab - band, size=C)
    persona = lo[:, None] + rng.integers(0, band, size=(C, Lp))
    history = lo[:, None, None] + rng.integers(0, band, size=(C, N, H * Lt))
    reply = lo[:, None, None] + rng.integers(0, band, size=(C, N, Lt))
    n = C * N
    persona = np.repeat(persona, N, axis=0)
    history = history.reshape(n, H, Lt)
    reply = reply.reshape(n, Lt)
    # the context: <bos> persona, then each history turn after its
    # speaker (the last turn before the reply is speaker1's)
    ctx = [np.full((n, 1), sp["<bos>"]), persona]
    ctx_types = [np.full((n, 1 + Lp), sp["<speaker2>"])]
    for i in range(H):
        spk = sp["<speaker1>"] if (H - i) % 2 == 1 else sp["<speaker2>"]
        ctx += [np.full((n, 1), spk), history[:, i]]
        ctx_types.append(np.full((n, 1 + Lt), spk))
    ctx = np.concatenate(ctx, axis=1)
    ctx_types = np.concatenate(ctx_types, axis=1)
    length = ctx.shape[1] + Lt + 2
    if length > T:
        raise ValueError(f"a dialog of {length} tokens exceeds max_seq_len "
                         f"{T}")
    ids = np.full((n, K, T), sp["<pad>"], np.int32)
    types = np.full((n, K, T), sp["<pad>"], np.int32)
    labels = np.full((n, K, T), IGNORE, np.int32)
    for j in range(K):
        true = j == K - 1
        cand = reply if true else reply[rng.integers(0, n, size=n)]
        seq = np.concatenate([ctx, np.full((n, 1), sp["<speaker2>"]), cand,
                              np.full((n, 1), sp["<eos>"])], axis=1)
        ids[:, j, :length] = seq
        types[:, j, :ctx.shape[1]] = ctx_types
        types[:, j, ctx.shape[1]:length] = sp["<speaker2>"]
        if true:
            labels[:, j, ctx.shape[1] + 1:length - 1] = cand
            labels[:, j, length - 1] = sp["<eos>"]
    data = {"input_ids": ids, "token_type_ids": types, "lm_labels": labels,
            "mc_token_ids": np.full((n, K), length - 1, np.int32),
            "mc_labels": np.full((n,), K - 1, np.int32)}
    return data, [np.arange(c * N, (c + 1) * N) for c in range(C)]


def cifar(tr: dict, num_classes: int, seed: int, device
          ) -> Tuple[Dict[str, np.ndarray], List[np.ndarray]]:
    """``(arrays, client_indices)``: ``x [n, 32, 32, 3]`` uint8 and ``y
    [n]`` int32; client c holds rows ``[c * n / C, (c + 1) * n / C)``."""
    n, C, hw = tr["num_images"], tr["num_clients"], tr["image_size"]
    g = torch.Generator(device=device).manual_seed(int(seed))
    protos = torch.rand((num_classes, hw, hw, 3), generator=g,
                        device=device) * 255.0
    y = torch.randint(0, num_classes, (n,), generator=g, device=device)
    x = protos[y] + 64.0 * torch.randn((n, hw, hw, 3), generator=g,
                                       device=device)
    x = x.clamp_(0.0, 255.0).to(torch.uint8)
    data = {"x": x.cpu().numpy(), "y": y.to(torch.int32).cpu().numpy()}
    per = n // C
    return data, [np.arange(c * per, (c + 1) * per) for c in range(C)]


def make(cfg: dict, tr: dict, seed: int, device):
    """The cell's training set for its configuration's family."""
    if cfg["family"] == "gpt2":
        return personachat(tr, cfg["vocab_size"], seed)
    return cifar(tr, cfg["num_classes"], seed, device)
