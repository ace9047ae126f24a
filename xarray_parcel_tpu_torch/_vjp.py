"""The gradient of a hand-written kernel: the VJP of its plain twin.

The kernels have no backward of their own.  As the JAX package's
``custom_vjp`` does for its Pallas kernel, a kernel's ``autograd.Function``
saves the inputs, and its backward recomputes the plain twin from them with
gradients on and returns the twin's vector-Jacobian product.  No residual
tracks are kept between the passes.
"""

import torch


def twin_vjp(twin, inputs, needs, grads):
    """Cotangents of ``inputs`` for output cotangents ``grads``, through
    ``twin(*inputs)`` (a tensor or a tuple of tensors).  ``needs`` says
    which inputs want one; the others, and inputs no output depends on,
    get None."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(n) for x, n in zip(inputs, needs)]
        outs = twin(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        wanted = [x for x in xs if x.requires_grad]
        if not pairs or not wanted:
            return [None] * len(inputs)
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       wanted, [g for _, g in pairs],
                                       allow_unused=True))
    return [next(got) if x.requires_grad else None for x in xs]
