"""FLOPs of a decoder-only MoE LM's federated round, and the work of its
flash-attention launches. Only useful work counts: the top-k experts a
token (never the capacity's padding or a dropped choice's slot), the
causal half of the attention pairs; a training token costs three
forwards."""
from __future__ import annotations

from fedbench import peaks
from fedbench.work import kernels


def active_params(cfg: dict) -> int:
    """Matmul parameters a token passes through: each layer's attention
    projections, its router and its top-k experts' three products, and
    the tied head."""
    D, dh = cfg["hidden_size"], cfg["head_dim"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    attn = D * (H + 2 * Hkv) * dh + H * dh * D
    experts = cfg["num_experts_per_tok"] * 3 * D * cfg["intermediate_size"]
    router = D * cfg["num_local_experts"]
    return (cfg["num_hidden_layers"] * (attn + experts + router)
            + D * cfg["vocab_size"])


def forward_flops(cfg: dict, seqs: int, seq_len: int) -> int:
    """One forward over ``seqs`` sequences: two FLOPs a multiply-add of
    the active parameters a token, and the attention's two products over
    the causal pairs."""
    attn, _ = kernels.flash_attention_work(
        seqs, seq_len, cfg["num_attention_heads"],
        cfg["num_key_value_heads"], cfg["head_dim"])
    return (2 * active_params(cfg) * seqs * seq_len
            + cfg["num_hidden_layers"] * attn)


def round_work(cfg: dict, traffic: dict) -> dict:
    """A round's model FLOPs (local training, the cross-test fold of K
    testers by N models, the global eval), its training tokens, and the
    bound of its flash launches (the fold and the global eval, a layer
    each): the larger of the operations at the bf16 peak and the bytes
    at the HBM rate."""
    fed, seq = traffic["fed"], traffic["data"]["seq_len"]
    trained = traffic.get("cohort") or fed["num_users"]
    train_seqs = trained * fed["local_steps"] * traffic["train"]["batch_size"]
    fold = fed["num_testers"] * trained * traffic["eval_rows"]
    flops = (3 * forward_flops(cfg, train_seqs, seq)
             + forward_flops(cfg, fold, seq)
             + forward_flops(cfg, traffic["global_rows"], seq))
    bound = 0.0
    for seqs in (fold, traffic["global_rows"]):
        f, b = kernels.flash_attention_work(
            seqs, seq, cfg["num_attention_heads"],
            cfg["num_key_value_heads"], cfg["head_dim"])
        bound += cfg["num_hidden_layers"] * max(
            f / peaks.PEAK_FLOPS["bfloat16"], b / peaks.HBM_BYTES_PER_S)
    return {"round_flops": flops, "round_tokens": train_seqs * seq,
            "flash_bound_s": bound}
