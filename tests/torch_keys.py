"""The JAX package's PRNG keys replayed into the port's dropout draws.

torch cannot reproduce jax.random, so the parity tests hand the port a
stand-in for its `nn.dropout.Draws` that asks jax.random for every mask and
every noise sample, key for key as the JAX package's train step derives
them: `step` splits the network key (`self._rng, sub = split(self._rng)`),
`split` and `fold_in` are jax.random's. A port network given
`JaxKeys.for_net(seed)` as its `draws` then sees the JAX network's masks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch


class JaxKeys:
    def __init__(self, key, device="cpu"):
        self.key = key
        self.device = torch.device(device)

    @classmethod
    def for_net(cls, seed, device="cpu"):
        """The keys of a JAX network seeded with `seed` (its `_rng`)."""
        return cls(jax.random.PRNGKey(seed), device)

    def _child(self, key):
        return JaxKeys(key, self.device)

    def step(self):
        self.key, sub = jax.random.split(self.key)
        return self._child(sub)

    def split(self, n):
        return [self._child(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, data):
        return self._child(jax.random.fold_in(self.key, data))

    def bernoulli(self, p, shape):
        keep = np.array(jax.random.bernoulli(self.key, p, tuple(shape)))
        return torch.from_numpy(keep).to(self.device)

    def normal(self, shape, dtype):
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        n = np.array(jax.random.normal(self.key, tuple(shape), jdt)
                     .astype(jnp.float32))
        return torch.from_numpy(n).to(self.device, dtype)
