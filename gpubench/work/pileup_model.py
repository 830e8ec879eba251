"""The pileup model's forward FLOP a site: each BiLSTM layer's
in-projection and recurrence, (D + H) x 4H multiply-adds a step and
direction, the proj, dense and gt / zy heads at the center. Inference
needs the last layer's center state only, (L + 1) / 2 steps a
direction; training runs every step of every layer.
"""


def forward_flop(model: dict, train: bool) -> float:
    L, H = model["seq_len"], model["hidden_size"]
    flop, d = 0, model["feature_dim"]
    for i in range(model["n_layers"]):
        last = i == model["n_layers"] - 1
        steps = L if train or not last else (L + 1) // 2
        flop += 2 * steps * 2 * (d + H) * 4 * H
        d = 2 * H
    flop += 2 * (2 * H * model["output_size"]
                 + model["output_size"] * model["inner_size"]
                 + model["inner_size"] * (model["gt_num_class"]
                                          + model["zy_num_class"]))
    return float(flop)
