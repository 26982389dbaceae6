"""A round's model FLOPs, counted from shapes: the forward and backward
passes' products that the configuration's model needs for every sample
of the round, a multiply-add as two operations, nothing recomputed and
elementwise work not counted. The backward of a product costs twice its
forward (the input's gradient and the weight's), except where the input
needs no gradient (the images entering the first convolution).

* GPT-2 a token: each block's four projections, the attention's two
  products over all T positions (the causal mask is applied to a full
  ``T x T`` product), and the tied LM head; the multiple-choice head,
  one score a candidate, is negligible and not counted.
* ResNet-9 an image: every 3x3 convolution at its output resolution
  (``padding 1``, so the input's) and the dense head."""

from __future__ import annotations

from benchmark.yardstick.layout import resnet9_stages


def gpt2_per_token(cfg: dict, T: int) -> float:
    E, L = cfg["n_embd"], cfg["n_layer"]
    inner = cfg["n_inner"] or 4 * E
    V = cfg["vocab_size"] + cfg["added_special_tokens"]
    proj = E * 3 * E + E * E + 2 * E * inner
    attn = 2 * T * E  # q k^T and probs v, per token and layer
    fwd = 2 * (L * (proj + attn) + E * V)
    return 3.0 * fwd


def resnet9_per_image(cfg: dict) -> float:
    hw = cfg["image_size"]
    total = 0.0
    first = True
    for name, cin, cout, pool in resnet9_stages(cfg):
        convs = [(cin, cout), (cout, cout)] if name.startswith("Residual") \
            else [(cin, cout)]
        for a, b in convs:
            fwd = 2.0 * 9 * a * b * hw * hw
            total += fwd * (2.0 if first else 3.0)
            first = False
        if pool:
            hw //= 2
    total += 3.0 * 2 * 8 * cfg["width"] * cfg["num_classes"]
    return total


def per_round(config: dict, tr: dict) -> float:
    """The round's FLOPs: W clients' batches, every sample."""
    rnd, data = tr["round"], tr["data"]
    samples = rnd["num_workers"] * rnd["local_batch_size"]
    if config["family"] == "gpt2":
        T = data["max_seq_len"]
        return samples * data["num_candidates"] * T * gpt2_per_token(
            config, T)
    return samples * resnet9_per_image(config)
