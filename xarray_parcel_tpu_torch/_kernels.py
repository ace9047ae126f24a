"""The one seam between the port and its hand-written kernels.

Every CUDA kernel of ``csrc/`` is called the same way, through a
:class:`Kernel`: a CPU tensor goes to the kernel's plain twin, a CUDA
tensor to the kernel, any other device raises.  On the card the float
inputs must be float32 or float64 of one dtype; the library's entry point
is the kernel's stem with ``_f32`` or ``_f64``, and each launch adds one
to the kernel's ``launches``.

The kernels have no backward of their own.  As the JAX package's
``custom_vjp`` does for its Pallas kernel, :class:`KernelCall`, the one
``autograd.Function`` of the port, saves the inputs; its backward
recomputes the plain twin from them with gradients on and returns the
twin's vector-Jacobian product.  No residual tracks are kept between the
passes.  A call goes through it when grad mode is on and an input the
kernel declares differentiable requires grad; otherwise, inference
included, it goes straight to the kernel.
"""

import inspect

import torch

from ._build import count, launch

_SUFFIX = {torch.float32: 'f32', torch.float64: 'f64'}


class Kernel:
    """A hand-written kernel and its plain twin, called as one function.

    ``what`` names the kernel in the error for a device that has none.
    ``twin(*args, **kw)`` is the computation as plain torch ops.
    ``card(launch, *args, **kw)`` does the rest on CUDA tensors: the
    kernel's own checks, its outputs' allocation, and
    ``launch(stem, pointers, batch, *widths)`` unless the batch is empty;
    it returns what the twin returns.  ``differentiable`` holds the
    positions of the inputs a gradient reaches.  A call takes the twin's
    signature: an argument given by keyword is bound to its position.
    Every tensor input must be on the first's device."""

    def __init__(self, what, twin, card, differentiable):
        self.what = what
        self.twin = twin
        self.card = card
        self.differentiable = tuple(differentiable)
        self.signature = inspect.signature(twin)
        self.launches = 0

    def __call__(self, *args, **kw):
        bound = self.signature.bind(*args, **kw)
        args, kw = bound.args, bound.kwargs
        if torch.is_grad_enabled() and any(
                args[i].requires_grad for i in self.differentiable):
            return KernelCall.apply(self, kw, *args)
        return self.run(*args, **kw)

    def run(self, *args, **kw):
        """The call without a gradient: the twin on a CPU tensor, the
        kernel on a CUDA one."""
        device = args[0].device
        if any(torch.is_tensor(x) and x.device != device for x in args):
            raise TypeError(f'{self.what} kernel inputs must share a device')
        if device.type == 'cpu':
            return self.twin(*args, **kw)
        if device.type != 'cuda':
            raise ValueError(f'no {self.what} kernel for device {device}')
        dtype = args[0].dtype
        if dtype not in _SUFFIX:
            raise TypeError(f'kernel takes float32 or float64, not {dtype}')
        if any(torch.is_tensor(x) and x.is_floating_point()
               and x.dtype != dtype for x in args):
            raise TypeError('kernel inputs must share dtype and device')

        def launch_entry(stem, pointers, batch, *widths):
            launch(f'{stem}_{_SUFFIX[dtype]}', device, pointers, batch,
                   *widths)
            count(self, 'launches')

        return self.card(launch_entry, *args, **kw)


class KernelCall(torch.autograd.Function):
    """A :class:`Kernel` call with a gradient: the forward runs the kernel
    (the twin on a CPU tensor); the backward recomputes the twin from the
    saved inputs and returns its VJP to the differentiable ones.  Other
    arguments (tables, options, ``with_profile``) pass through.  The node
    in the graph keeps the kernel as ``.kernel``."""

    @staticmethod
    def forward(ctx, kernel, kw, *args):
        ctx.kernel, ctx.kw = kernel, kw
        ctx.others = [None if torch.is_tensor(x) else x for x in args]
        ctx.save_for_backward(*(x if torch.is_tensor(x) else None
                                for x in args))
        return kernel.run(*args, **kw)

    @staticmethod
    def backward(ctx, *grads):
        needs = [i in ctx.kernel.differentiable and ctx.needs_input_grad[2 + i]
                 for i in range(len(ctx.others))]
        with torch.enable_grad():
            xs = [o if x is None else x.detach().requires_grad_(n)
                  for x, o, n in zip(ctx.saved_tensors, ctx.others, needs)]
            outs = ctx.kernel.twin(*xs, **ctx.kw)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            wanted = [x for x, n in zip(xs, needs) if n]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wanted, [g for _, g in pairs],
                allow_unused=True) if pairs and wanted else ())
        return (None, None, *(next(got, None) if n else None for n in needs))
