"""The haplotype model's forward FLOP a site: both branches' BiLSTM
stacks (the pileup view over 33 positions, the haplotype view over 11),
(D + H) x 4H multiply-adds a step and direction, then both projections,
the dense layer and the gt / zy heads at the center. Inference needs each
last layer's center state only, (L + 1) / 2 steps a direction.
"""


def forward_flop(model: dict, train: bool) -> float:
    H = model["hidden_size"]
    flop = 0
    for L, d in ((model["pileup_length"], model["pileup_dim"]),
                 (model["haplotype_length"], model["haplotype_dim"])):
        for i in range(model["lstm_layers"]):
            last = i == model["lstm_layers"] - 1
            steps = L if train or not last else (L + 1) // 2
            flop += 2 * steps * 2 * (d + H) * 4 * H
            d = 2 * H
    flop += 2 * (2 * (2 * H * H) + 2 * H * H
                 + H * (model["gt_num_class"] + model["zy_num_class"]))
    return float(flop)
