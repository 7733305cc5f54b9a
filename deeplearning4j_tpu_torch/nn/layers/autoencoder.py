"""AutoEncoder, RBM and VariationalAutoencoder (counterpart of
deeplearning4j_tpu/nn/layers/autoencoder.py; nn/conf/layers/{AutoEncoder,
RBM}.java, nn/conf/layers/variational/VariationalAutoencoder.java).

Each layer is a plain feed-forward layer in a supervised forward (`apply`:
the AutoEncoder's and RBM's encode, the VAE's mean of q(z|x)) and has its
own unsupervised objective, `pretrain_loss(params, x, rng)`, which
`MultiLayerNetwork.pretrain` / `pretrain_layer` minimize layer by layer.
`rng` is the step's draws (`nn.dropout.Draws` or a stand-in with the same
methods) or None: the AutoEncoder's corruption mask, the RBM's Gibbs
samples and the VAE's reparameterization noise come from it, split and
folded as the JAX package splits and folds its keys.

Products are the JAX package's plain `@` (`ops.linear.matmul`: promoted
operands, no mixed cast). No TPU kernel runs in these layers. Param names
are the JAX package's ("W", "b", "vb"; the VAE's "eW{i}", "eb{i}", "mW",
"mb", "vW", "vb", "dW{i}", "db{i}", "xW", "xb"), in the same layout, so
`interop` carries them across unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.nn import activations as act_mod
from deeplearning4j_tpu_torch.nn import initializers as init_mod
from deeplearning4j_tpu_torch.nn import inputs as it
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.ops.linear import matmul

_LOG_2PI = math.log(2 * math.pi)


@register_layer
@dataclass
class AutoEncoder(Layer):
    """Denoising autoencoder: encode = act(xW + b), decode with the tied
    weights W^T and the visible bias vb; the pretrain loss is the
    reconstruction error of the input from its corrupted copy. `sparsity`
    is carried in the configuration and read nowhere, as in the JAX
    package."""

    n_in: Optional[int] = None
    n_out: int = 0
    corruption_level: float = 0.3
    sparsity: float = 0.0

    def output_type(self, input_type):
        return it.FeedForward(self.n_out)

    def init_params(self, gen, input_type):
        n_in = self.n_in or input_type.arity()
        return {
            "W": init_mod.init(self.weight_init or "xavier", gen,
                               (n_in, self.n_out), distribution=self.dist),
            "b": torch.zeros(self.n_out),
            "vb": torch.zeros(n_in),  # visible bias (decode)
        }

    def encode(self, params, x):
        return self.act_fn("sigmoid")(matmul(x, params["W"]) + params["b"])

    def decode(self, params, h):
        return self.act_fn("sigmoid")(matmul(h, params["W"].t())
                                      + params["vb"])

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        return self.encode(params, x), state

    def pretrain_loss(self, params, x, rng):
        """mean over rows of sum((decode(encode(x_c)) - x)^2), x_c the
        input with each entry kept with probability 1 - corruption_level
        and zeroed otherwise (no corruption without draws)."""
        if rng is not None and self.corruption_level > 0:
            keep = rng.bernoulli(1.0 - self.corruption_level, x.shape)
            x_c = torch.where(keep, x, 0.0)
        else:
            x_c = x
        recon = self.decode(params, self.encode(params, x_c))
        return ((recon - x) ** 2).sum(dim=-1).mean()


@register_layer
@dataclass
class RBM(AutoEncoder):
    """Restricted Boltzmann Machine (nn/conf/layers/RBM.java), pretrained
    by CD-k: a Gibbs chain of `cd_k` sweeps (hidden states sampled, the
    visible ones sampled for binary units and their means for gaussian
    ones; the last sweep keeps probabilities or means) gives the model's
    negative sample v_k, and the loss is the surrogate
    mean F(x) - mean F(v_k) with v_k held constant, whose gradient is the
    CD-k gradient. The chain is a Python loop over the sweeps, run without
    gradient. objective="reconstruction" takes the AutoEncoder's loss
    instead; rng=None runs the chain mean-field."""

    visible_unit: str = "binary"   # binary | gaussian
    hidden_unit: str = "binary"
    objective: str = "cd"          # cd | reconstruction
    cd_k: int = 1

    def free_energy(self, params, v):
        """F(v) = -v.vb - sum softplus(vW + b) (binary visible); gaussian
        visible units take 0.5 ||v - vb||^2 for -v.vb."""
        pre = matmul(v, params["W"]) + params["b"]
        # jax.nn.softplus is logaddexp(x, 0), exact past torch's threshold
        hidden_term = torch.logaddexp(pre, torch.zeros_like(pre)).sum(dim=-1)
        if self.visible_unit == "gaussian":
            visible_term = 0.5 * ((v - params["vb"]) ** 2).sum(dim=-1)
        else:
            visible_term = -matmul(v, params["vb"])
        return visible_term - hidden_term

    def _prop_down(self, params, h):
        mean = matmul(h, params["W"].t()) + params["vb"]
        if self.visible_unit == "gaussian":
            return mean
        return torch.sigmoid(mean)

    def gibbs_chain(self, params, v0, rng, k: Optional[int] = None):
        """k alternating Gibbs sweeps from v0; returns the last sweep's
        visible probabilities (binary) or means (gaussian). Sweep i draws
        from rng.split(k)[i], split again into (hidden, visible)."""
        k = int(k or self.cd_k)
        keys = rng.split(k) if rng is not None else [None] * k
        v, pv = v0, None
        for key in keys:
            ph = torch.sigmoid(matmul(v, params["W"]) + params["b"])
            if key is None:
                h = ph
            else:
                kh, kv = key.split(2)
                h = kh.bernoulli(ph, ph.shape).to(v.dtype)
            pv = self._prop_down(params, h)
            if key is None or self.visible_unit == "gaussian":
                v = pv
            else:
                v = kv.bernoulli(pv, pv.shape).to(v.dtype)
        return pv

    def pretrain_loss(self, params, x, rng):
        if self.objective == "reconstruction":
            return super().pretrain_loss(params, x, rng)
        if self.hidden_unit != "binary":
            # the CD chain and free energy implement binary hidden units
            # only; failing loudly beats silently-wrong statistics
            raise ValueError(
                f"RBM CD pretraining supports hidden_unit='binary' only "
                f"(got {self.hidden_unit!r}); use "
                f"objective='reconstruction' for other hidden units")
        with torch.no_grad():
            v_model = self.gibbs_chain(params, x, rng)
        return (self.free_energy(params, x).mean()
                - self.free_energy(params, v_model).mean())


@register_layer
@dataclass
class VariationalAutoencoder(Layer):
    """VAE (nn/conf/layers/variational/VariationalAutoencoder.java): an
    encoder MLP to (mean, logvar) of q(z|x), a reparameterized z, a decoder
    MLP to the reconstruction distribution's parameters (gaussian: mean
    and logvar per input; bernoulli: logits). The supervised forward is
    pzx_activation(mean); the pretrain loss is -ELBO."""

    n_in: Optional[int] = None
    n_out: int = 0  # latent size (nOut in the reference config)
    encoder_layer_sizes: List[int] = field(default_factory=lambda: [256])
    decoder_layer_sizes: List[int] = field(default_factory=lambda: [256])
    reconstruction_distribution: str = "gaussian"  # gaussian | bernoulli
    pzx_activation: str = "identity"
    num_samples: int = 1

    def output_type(self, input_type):
        return it.FeedForward(self.n_out)

    def init_params(self, gen, input_type):
        """The JAX package's params in its order, each weight drawn by
        `weight_init` (no distribution, as there), biases zero."""
        n_in = self.n_in or input_type.arity()
        wi = self.weight_init or "xavier"
        p = {}
        sizes_e = [n_in] + list(self.encoder_layer_sizes)
        for i in range(len(sizes_e) - 1):
            p[f"eW{i}"] = init_mod.init(wi, gen, (sizes_e[i], sizes_e[i + 1]))
            p[f"eb{i}"] = torch.zeros(sizes_e[i + 1])
        last_e = sizes_e[-1]
        p["mW"] = init_mod.init(wi, gen, (last_e, self.n_out))
        p["mb"] = torch.zeros(self.n_out)
        p["vW"] = init_mod.init(wi, gen, (last_e, self.n_out))
        p["vb"] = torch.zeros(self.n_out)
        sizes_d = [self.n_out] + list(self.decoder_layer_sizes)
        for i in range(len(sizes_d) - 1):
            p[f"dW{i}"] = init_mod.init(wi, gen, (sizes_d[i], sizes_d[i + 1]))
            p[f"db{i}"] = torch.zeros(sizes_d[i + 1])
        out = n_in * (2 if self.reconstruction_distribution == "gaussian"
                      else 1)
        p["xW"] = init_mod.init(wi, gen, (sizes_d[-1], out))
        p["xb"] = torch.zeros(out)
        return p

    def _encode(self, params, x):
        act = self.act_fn("leakyrelu")
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = act(matmul(h, params[f"eW{i}"]) + params[f"eb{i}"])
        mean = matmul(h, params["mW"]) + params["mb"]
        logvar = matmul(h, params["vW"]) + params["vb"]
        return mean, logvar

    def _decode(self, params, z):
        act = self.act_fn("leakyrelu")
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = act(matmul(h, params[f"dW{i}"]) + params[f"db{i}"])
        return matmul(h, params["xW"]) + params["xb"]

    def apply(self, params, x, *, state, train, mask=None, rng=None):
        mean, _ = self._encode(params, x)
        return act_mod.get(self.pzx_activation)(mean), state

    def _log_px(self, out, x):
        """log p(x | z) per row from the decoder's output: the gaussian's
        (with log 2pi) or the bernoulli's (probabilities clipped to
        [1e-7, 1 - 1e-7])."""
        n_in = x.shape[-1]
        if self.reconstruction_distribution == "gaussian":
            x_mean, x_logvar = out[..., :n_in], out[..., n_in:]
            return -0.5 * (x_logvar + (x - x_mean) ** 2 / torch.exp(x_logvar)
                           + _LOG_2PI).sum(dim=-1)
        p = torch.clamp(torch.sigmoid(out), 1e-7, 1 - 1e-7)
        return (x * torch.log(p) + (1 - x) * torch.log1p(-p)).sum(dim=-1)

    def pretrain_loss(self, params, x, rng):
        """-ELBO = reconstruction NLL + KL(q(z|x) || N(0, I)), the mean over
        rows; one z per row (the mean without draws)."""
        mean, logvar = self._encode(params, x)
        eps = (rng.normal(mean.shape, mean.dtype) if rng is not None
               else torch.zeros_like(mean))
        z = mean + torch.exp(0.5 * logvar) * eps
        nll = -self._log_px(self._decode(params, z), x)
        kl = 0.5 * (torch.exp(logvar) + mean ** 2 - 1.0 - logvar).sum(dim=-1)
        return (nll + kl).mean()

    def reconstruction_probability(self, params, x, rng, num_samples=None):
        """Monte-carlo estimate of log p(x) per row over `num_samples`
        draws of z, sample i from rng.fold_in(i) (the reference's
        reconstructionProbability, used for anomaly detection)."""
        ns = num_samples or self.num_samples
        mean, logvar = self._encode(params, x)
        total = torch.zeros(x.shape[0], device=x.device)
        for i in range(ns):
            eps = rng.fold_in(i).normal(mean.shape, mean.dtype)
            z = mean + torch.exp(0.5 * logvar) * eps
            total = total + self._log_px(self._decode(params, z), x)
        return total / ns
