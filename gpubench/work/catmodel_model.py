"""The legacy CatModel's forward FLOP a site: the ResCRNN conv tower's
convolutions (work/_conv_tower.py), the five BiLSTM layers (the
percentage stack of three over [11, 20], the two CRNN layers over the
tower's [11, 256]), (D + H) x 4H multiply-adds a step and direction over
all 11 steps, the three 512 -> 256 projections at every step and the
head at the center.
"""
import harness


def forward_flop(model: dict, train: bool) -> float:
    tower = harness.load_module("work", "_conv_tower")
    L, H, P = model["positions"], model["hidden_size"], model["proj_size"]
    flop = sum(c["flop"] for c in tower.convs(model) if c["pass"] == "fprop")
    stacks = [(model["percentage_dim"], model["percentage_layers"]),
              (model["res_blocks"][-1][1], 1), (P, 1)]
    for d, layers in stacks:
        for _ in range(layers):
            flop += 2 * L * 2 * (d + H) * 4 * H
            d = 2 * H
    flop += 3 * 2 * L * 2 * H * P + 2 * 2 * P * model["gt_num_class"]
    return float(flop)
