"""JAX on the CPU at bf16, as the port's tests run it: the compile of a
reference with XLA's excess precision off, and ``jax.numpy`` with the
f32-accumulated einsums of bf16 operands widened (XLA on the CPU cannot
execute BF16 x BF16 = F32; a product of two bf16 values is exact in f32,
so the sum is the same f32 sum). Kept apart from the test modules so a
child process that computes references imports JAX and nothing else.
"""

import jax
import jax.numpy as jnp


class _WidenedEinsum:
    """``jax.numpy`` for the JAX BiLSTM, whose f32-accumulated einsums
    take f32 operands (see the module docstring)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return jnp.einsum(spec, *ops,
                          preferred_element_type=preferred_element_type, **kw)


def _no_excess(fn, *args):
    """``fn(*args)`` compiled with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={'xla_allow_excess_precision': False})(*args)
