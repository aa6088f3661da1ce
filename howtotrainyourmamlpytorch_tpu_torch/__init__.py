"""PyTorch/CUDA port of the MAML / MAML++ framework.

The JAX package ``howtotrainyourmamlpytorch_tpu`` is the reference; this
package mirrors its layout (``models/vgg.py`` <-> ``models/vgg.py``, ...)
and keeps its public layouts (NHWC activations, HWIO conv weights, flat
parameter keys), so each module can be held to its counterpart on the same
inputs. It imports torch, numpy and the standard library only.

The first slice is the serving path: ``serving.engine.ServingEngine``
adapts each tenant with first-order inner steps and predicts its queries,
with the conv -> batch-norm -> leaky-ReLU -> max-pool block on hand-written
Hopper kernels (``kernels/``).
"""
