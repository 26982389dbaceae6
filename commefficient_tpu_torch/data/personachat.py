"""FedPersona — PersonaChat for the GPT-2 workload, one dialog set a client
(the port's own copy of the reference's ``data/personachat.py``).

Each example is a dialog context plus ``num_candidates`` candidate replies
(the last one true, the others distractors from other clients), assembled
by ``build_input_from_segments`` with the special tokens ``<bos> <eos>
<speaker1> <speaker2> <pad>`` appended to the base vocabulary; LM labels
cover only the true reply, and the MC head picks the true candidate. The
tokens come from the real ``personachat_self_original.json`` (tokenized
with a GPT-2 tokenizer already on disk) or, without it, from a synthetic
corpus of persona-conditioned integer sequences with the same shapes. The
same seed gives the reference's arrays, bit for bit (pinned by
tests/test_torch_gpt2.py).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import FedDataset

# appended at the end of the base vocabulary, in this order
SPECIAL_TOKENS = ("<bos>", "<eos>", "<speaker1>", "<speaker2>", "<pad>")


def special_ids(base_vocab: int) -> Dict[str, int]:
    return {name: base_vocab + i for i, name in enumerate(SPECIAL_TOKENS)}


def vocab_with_specials(base_vocab: int) -> int:
    return base_vocab + len(SPECIAL_TOKENS)


def build_input_from_segments(persona: List[List[int]],
                              history: List[List[int]], reply: List[int],
                              sp: Dict[str, int], *, lm_labels: bool,
                              max_len: int) -> Dict[str, np.ndarray]:
    """One candidate sequence: ``<bos>`` persona, then the history turns
    alternating ``<speaker2>``/``<speaker1>``, then ``<speaker2>`` reply
    ``<eos>``. Token types mark each position with its speaker token; LM
    labels are -100 except on the true reply. Left-truncated to
    ``max_len``, padded on the right."""
    seq = [sp["<bos>"]] + [t for p in persona for t in p]
    types = [sp["<speaker2>"]] * len(seq)
    for i, turn in enumerate(history):
        spk = (sp["<speaker1>"] if (len(history) - i) % 2 == 1
               else sp["<speaker2>"])
        seq += [spk] + turn
        types += [spk] * (len(turn) + 1)
    reply_seq = [sp["<speaker2>"]] + reply + [sp["<eos>"]]
    seq += reply_seq
    types += [sp["<speaker2>"]] * len(reply_seq)
    labels = [-100] * (len(seq) - len(reply_seq)) + (
        [-100] + reply + [sp["<eos>"]] if lm_labels
        else [-100] * len(reply_seq))
    seq, types, labels = seq[-max_len:], types[-max_len:], labels[-max_len:]
    mc_token = len(seq) - 1  # the last real token
    pad = max_len - len(seq)
    return {
        "input_ids": np.asarray(seq + [sp["<pad>"]] * pad, np.int32),
        "token_type_ids": np.asarray(types + [sp["<pad>"]] * pad, np.int32),
        "lm_labels": np.asarray(labels + [-100] * pad, np.int32),
        "mc_token_ids": np.asarray(mc_token, np.int32),
    }


def _synthetic_dialogs(num_clients: int, *, base_vocab: int,
                       dialogs_per_client: int = 8, turn_len: int = 12,
                       seed: int = 11):
    """Persona-conditioned integer dialogs: each client's turns come from
    its own band of 200 tokens, so the true candidate is statistically
    distinguishable from distractors drawn from other clients."""
    rng = np.random.default_rng(seed)
    clients = []
    for _ in range(num_clients):
        lo = rng.integers(0, max(1, base_vocab - 200))
        band = (int(lo), int(lo) + 200)
        persona = [list(rng.integers(*band, size=turn_len))
                   for _ in range(3)]
        dialogs = []
        for _ in range(dialogs_per_client):
            history = [list(rng.integers(*band, size=turn_len))
                       for _ in range(3)]
            reply = list(rng.integers(*band, size=turn_len))
            dialogs.append((persona, history, reply))
        clients.append(dialogs)
    return clients


def _load_real_dialogs(path: str, max_history: int):
    """personachat_self_original.json -> per-client (persona, history,
    reply) token lists. Needs ``transformers`` and a GPT-2 tokenizer
    already on disk."""
    from transformers import GPT2Tokenizer  # the vocab must be on disk

    tok = GPT2Tokenizer.from_pretrained("gpt2")
    with open(path) as f:
        raw = json.load(f)["train"]
    clients = []
    for dialog in raw:
        persona = [tok.encode(p) for p in dialog["personality"]]
        dialogs = []
        for utt in dialog["utterances"]:
            history = [tok.encode(h)
                       for h in utt["history"][-(2 * max_history + 1):]]
            dialogs.append((persona, history,
                            tok.encode(utt["candidates"][-1])))
        clients.append(dialogs)
    return clients


def load_fed_personachat(dataset_dir: str, *, num_clients: int = 64,
                         num_candidates: int = 2, max_history: int = 2,
                         max_seq_len: int = 128, base_vocab: int = 512,
                         seed: int = 42
                         ) -> Tuple[FedDataset, FedDataset, bool, int]:
    """``(train, test, is_real, vocab size with the specials)``. Each
    example: ``input_ids``, ``token_type_ids``, ``lm_labels`` ``[N, T]``,
    ``mc_token_ids [N]`` and ``mc_labels`` (always the last candidate).
    Distractors are replies of other clients; each client's dialogs split
    90/10 into train and test."""
    path = os.path.join(dataset_dir, "personachat_self_original.json")
    real = os.path.exists(path)
    if real:
        clients = _load_real_dialogs(path, max_history)[:num_clients]
        base_vocab = 50257
    else:
        clients = _synthetic_dialogs(num_clients, base_vocab=base_vocab,
                                     seed=seed)
    sp = special_ids(base_vocab)
    rng = np.random.default_rng(seed)
    keys = ("input_ids", "token_type_ids", "lm_labels", "mc_token_ids")
    rows = {k: [] for k in keys + ("mc_labels",)}
    client_indices: List[np.ndarray] = []
    all_replies = [d[2] for cl in clients for d in cl]
    row = 0
    for dialogs in clients:
        start = row
        for persona, history, reply in dialogs:
            cands = [all_replies[rng.integers(len(all_replies))]
                     for _ in range(num_candidates - 1)]
            cands.append(reply)  # the true candidate last
            per_cand = [build_input_from_segments(
                persona, history, c, sp, lm_labels=(j == num_candidates - 1),
                max_len=max_seq_len) for j, c in enumerate(cands)]
            for k in keys:
                rows[k].append(np.stack([pc[k] for pc in per_cand]))
            rows["mc_labels"].append(np.asarray(num_candidates - 1, np.int32))
            row += 1
        client_indices.append(np.arange(start, row))
    data = {k: np.stack(v) for k, v in rows.items()}
    train_ix, test_ix = [], []
    for ix in client_indices:
        cut = max(1, int(0.9 * len(ix)))
        train_ix.append(ix[:cut])
        test_ix.append(ix[cut:])
    train = FedDataset(data, len(clients), client_indices=train_ix,
                       seed=seed)
    test_all = np.concatenate(test_ix)
    test = FedDataset({k: v[test_all] for k, v in data.items()}, 1,
                      iid=True, seed=seed)
    return train, test, real, vocab_with_specials(base_vocab)
