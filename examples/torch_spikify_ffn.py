"""MENAGE-style event-driven execution of a transformer FFN block, in
PyTorch (the twin of examples/spikify_ffn.py).

The paper's "work follows spikes" applied to a conventional layer: the ReLU
activations of an FFN are rate-encoded and pushed through the port's
hand-written ``event_synapse`` kernel, so the weight-row traffic scales
with the activations' sparsity instead of the dense ``n_in``.  The frames
are drawn from an explicit ``torch.Generator`` on the device.

  PYTHONPATH=src python examples/torch_spikify_ffn.py
  PYTHONPATH=src python examples/torch_spikify_ffn.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.core.spikify import spikified_linear
from repro_torch.device import exact_float32, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the event_synapse kernel on the card "
                         "(raises with no card); cpu: its plain version")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    d_model, d_ff, batch = 256, 1024, 8
    # drawn and scaled as the original (its float64 quotients rounded to
    # float32, as jnp.asarray rounds them)
    w_in = rng.normal(size=(d_model, d_ff)).astype(np.float32) \
        / np.sqrt(d_model)
    w_out = rng.normal(size=(d_ff, d_model)).astype(np.float32) \
        / np.sqrt(d_ff)
    x = rng.normal(size=(batch, d_model)).astype(np.float32)
    w_in, w_out, x = (torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                      for a in (w_in, w_out, x))

    # dense reference FFN, float32 products
    with exact_float32(dev):
        h = torch.relu(x @ w_in)
        y_ref = h @ w_out
    sparsity = float((h == 0).float().mean())
    print(f"FFN {d_model}->{d_ff}->{d_model} on {dev.type}; "
          f"ReLU sparsity {sparsity:.1%}")

    errs = []
    for t in (16, 64, 256):
        y, stats = spikified_linear(
            torch.Generator(device=dev).manual_seed(1), h, w_out,
            num_steps=t)
        err = float((y - y_ref).abs().mean() / y_ref.abs().mean())
        frac = float(stats["event_fraction"])
        assert np.isfinite(err) and 0.0 < frac <= 1.0 - sparsity + 1e-6
        errs.append(err)
        print(f"T={t:4d}: rel err {err:6.3f}, "
              f"event fraction {frac:.3f} (weight-row traffic vs dense)")
    assert errs[-1] < errs[0], "error does not fall with T"

    print("-> error falls ~1/sqrt(T); traffic tracks activation sparsity —")
    print("   the paper's event-driven energy story, on the hand-written "
          "kernel.")


if __name__ == "__main__":
    main()
