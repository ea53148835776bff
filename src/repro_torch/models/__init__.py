"""The paper's classifiers and the LMs (dense, moe, Mamba2 ssm, the Jamba
hybrid, whisper's encoder-decoder and the vlm) in PyTorch (the port's
side of ``repro.models``).

Params are plain nested dicts of tensors in the reference's names,
layouts and dtypes (conv weights HWIO, dense weights ``[in, out]``,
LM layers stacked ``[L, ...]``). Each classifier family's
``nn.Module`` holds no weights of its own and is driven through
``torch.func.functional_call``, so one module serves a single model and a
``vmap`` over a client-stacked param tree alike; the LMs are plain
functions over their param trees.
"""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
