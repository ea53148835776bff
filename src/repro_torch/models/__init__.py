"""The paper's classifiers and the decoder LMs (dense, moe, Mamba2 ssm
and the Jamba hybrid) in PyTorch (``repro.models`` less encdec and vlm).

Params are plain nested dicts of tensors in the reference's names,
layouts and dtypes (conv weights HWIO, dense weights ``[in, out]``,
decoder layers stacked ``[L, ...]``). Each classifier family's
``nn.Module`` holds no weights of its own and is driven through
``torch.func.functional_call``, so one module serves a single model and a
``vmap`` over a client-stacked param tree alike; the decoder is plain
functions over its param tree.
"""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
