"""Does Adam's bias-corrected division give the same bits with the step count
on the host and on the device?

``clip_adam_step`` divides the moments by the bias corrections 1 − b^count.
With a host count they are Python floats (``torch._foreach_div(list,
float)``); with the count on the device they are 0-d float32 tensors
(``torch._foreach_div(list, tensor)``). This compares the two on the card,
for b in (0.9, 0.999) and counts 1 … 4000, on four (256, 200) tensors, with
elementwise true division (``x / t``) and multiplication by the reciprocal,
and prints the number of elements that differ for each pair.

    python scripts/probe_adam_div.py      # needs a CUDA card
"""
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_adam_div.py needs a CUDA card", file=sys.stderr)
        return 1
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    a = [torch.randn(256, 200, device=dev, generator=g).abs() * 1e-3
         for _ in range(4)]
    mism = {"scalar_vs_tensor": 0, "scalar_vs_true": 0, "tensor_vs_true": 0,
            "scalar_vs_recip": 0, "tensor_vs_recip": 0, "list_vs_scalar": 0}
    for k in range(1, 4001):
        for b in (0.9, 0.999):
            s = 1 - b ** k
            t = (1 - torch.pow(b, torch.tensor(float(k), dtype=torch.float64,
                                               device=dev))).float()
            xs = torch._foreach_div(a, s)
            xt = torch._foreach_div(a, t)
            xl = torch._foreach_div(a, [t] * len(a))
            tr = [x / t for x in a]
            rc = [x * (1.0 / t) for x in a]
            for name, p, q in (("scalar_vs_tensor", xs, xt),
                               ("scalar_vs_true", xs, tr),
                               ("tensor_vs_true", xt, tr),
                               ("scalar_vs_recip", xs, rc),
                               ("tensor_vs_recip", xt, rc),
                               ("list_vs_scalar", xl, xs)):
                mism[name] += sum(int((u != v).sum()) for u, v in zip(p, q))
    print(torch.__version__, torch.cuda.get_device_name(0))
    print("elements compared per pair:", 4000 * 2 * sum(x.numel() for x in a))
    print(mism)
    return 0


if __name__ == "__main__":
    sys.exit(main())
