"""The JAX package's PRNG keys replayed into the port's dropout draws.

torch cannot reproduce jax.random, so the parity tests hand the port a
stand-in for its `nn.dropout.Draws` that asks jax.random for every mask and
every noise sample, key for key as the JAX package's train step derives
them: `step` splits the network key (`self._rng, sub = split(self._rng)`),
`split` and `fold_in` are jax.random's. A port network given
`JaxKeys.for_net(seed)` as its `draws` then sees the JAX network's masks
(and, in layerwise pretraining, its corruption masks, Gibbs samples and
VAE noise).
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
        if isinstance(p, torch.Tensor):
            # bernoulli(key, p) with an array p is uniform(key, p.shape,
            # p.dtype) < p: JAX's uniforms against the port's own p
            jdt = jnp.float64 if p.dtype == torch.float64 else jnp.float32
            u = np.array(jax.random.uniform(self.key, tuple(shape), jdt))
            return torch.from_numpy(u).to(p.device, p.dtype) < p
        keep = np.array(jax.random.bernoulli(self.key, p, tuple(shape)))
        return torch.from_numpy(keep).to(self.device)

    def normal(self, shape, dtype):
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        n = np.array(jax.random.normal(self.key, tuple(shape), jdt)
                     .astype(jnp.float32))
        return torch.from_numpy(n).to(self.device, dtype)
