"""Evaluation of the port (counterpart of deeplearning4j_tpu/eval): the
evaluators are numpy copies of the JAX package's and run on the host, as
there. The networks' `output` returns a tensor on their device, so
`eval_over` copies each batch's output to the host once; labels and masks
are copied only where they are tensors.
"""
import inspect

import torch

from deeplearning4j_tpu_torch.eval.binary import EvaluationBinary  # noqa: F401
from deeplearning4j_tpu_torch.eval.calibration import EvaluationCalibration  # noqa: F401
from deeplearning4j_tpu_torch.eval.evaluation import ConfusionMatrix, Evaluation  # noqa: F401
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation  # noqa: F401
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCBinary, ROCMultiClass  # noqa: F401


def host(a):
    """An array as numpy: a tensor is copied to the host once (bfloat16 and
    float16 as float32, which numpy holds); anything else is left as it
    is."""
    if not isinstance(a, torch.Tensor):
        return a
    a = a.detach()
    if a.dtype in (torch.bfloat16, torch.float16):
        a = a.float()
    return a.cpu().numpy()


def mask_aware_feeder(ev):
    """feeder(labels, out, mask) for one evaluator: forwards the labels
    mask only when `ev.eval` accepts one (the ROC variants take none), and
    brings tensors to the host. Build once per evaluator per pass."""
    if "mask" in inspect.signature(ev.eval).parameters:
        return lambda labels, out, mask: ev.eval(host(labels), host(out),
                                                 mask=host(mask))
    return lambda labels, out, mask: ev.eval(host(labels), host(out))


def eval_over(output_fn, iterator, ev):
    """The per-batch loop of the networks' evaluate* family
    (MultiLayerNetwork.evaluate, ComputationGraph.doEvaluation): each
    batch's output, copied to the host, fed to `ev` with the labels and
    the labels mask. Returns `ev`."""
    feed = mask_aware_feeder(ev)
    for ds in iterator:
        out = host(output_fn(ds.features))
        feed(ds.labels, out, ds.labels_mask)
    return ev

