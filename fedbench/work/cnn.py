"""FLOPs of the paper's CNN (3 conv + 2 FC) and of one FedTest round on
it. A multiply-add is two FLOPs; a training sample costs three forwards
(forward, and the backward's two products); pooling, activations and the
optimizer are not counted."""
from __future__ import annotations

from fedbench.work import kernels


def forward_macs(cfg: dict) -> int:
    """Multiply-adds of one forward sample: 3x3 "same" convolutions, each
    followed by a 2x2 pool (odd sizes round up), then two dense layers."""
    size, chans = cfg["image_size"], [cfg["image_channels"]]
    chans += list(cfg["cnn_channels"])
    macs = 0
    for cin, cout in zip(chans, chans[1:]):
        macs += size * size * 9 * cin * cout
        size = (size + 1) // 2
    flat = size * size * chans[-1]
    macs += flat * cfg["cnn_hidden"] + cfg["cnn_hidden"] * cfg["num_classes"]
    return macs


def forward_flops(cfg: dict) -> int:
    return 2 * forward_macs(cfg)


def round_flops(cfg: dict, traffic: dict) -> int:
    """Model FLOPs of one round: every trained client's local steps, the
    testers' cross-test of every model (tiles and padding are not useful
    work and are not counted) and the global accuracy's forward."""
    fed, train = traffic["fed"], traffic["train"]
    trained = traffic.get("cohort") or fed["num_users"]
    samples = trained * fed["local_steps"] * train["batch_size"]
    tests = fed["num_testers"] * trained * traffic["eval_rows"]
    fwd = forward_flops(cfg)
    return 3 * fwd * samples + fwd * (tests + traffic["global_rows"])


def round_work(cfg: dict, traffic: dict) -> dict:
    """What the readers of a CNN cell divide by: a round's model FLOPs
    and the bytes of its ``weighted_aggregate`` launch (the clients'
    models, their weights and the new global model, f32)."""
    clients = traffic.get("cohort") or traffic["fed"]["num_users"]
    return {"round_flops": round_flops(cfg, traffic),
            "aggregate_bytes": kernels.weighted_aggregate_bytes(
                clients, cfg["params"])}
