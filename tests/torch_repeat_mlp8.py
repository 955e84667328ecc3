"""Repeat one case of tests/test_torch_kernels_cuda.py's
test_mlp_gemv_int8_ldg_matches_plain many times in one process and count,
check by check, how often each of its assertions would fail and by how
much (not a test; needs the card). Run from the repo root:

    python tests/torch_repeat_mlp8.py [--shape h1152_i384] [--repeats 200]

Each repetition is the test's own sequence from a fresh seed-0 generator
(its fixture): rows 1-8 over a bf16 x and 3 rows over an f32 x, each
within its tolerance of the plain version (2^-7 / 1e-5 of max|plain|) and
equal on a second call; 22 more calls bit-identical at 1 and 8 rows; two
kernels a call over a bf16 x and four over an f32 x. Prints one JSON line."""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import test_torch_kernels_cuda as t  # noqa: E402
from palu_tpu_torch.ops import gemv_int8 as g8  # noqa: E402


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def repeat(shape: str, repeats: int) -> dict:
    h, inter = t.MLP8_SHAPES[shape]
    fails = {"within_tol": 0, "second_call_equal": 0, "repeat_calls_equal": 0,
             "kernels_per_call": 0, "finite_shape_dtype": 0}
    worst = {"rel_over_tol": 0.0, "repeat_max_abs_diff": 0.0}
    kernels_seen = set()
    failed_reps = []
    for rep in range(repeats):
        gen = torch.Generator(device="cuda").manual_seed(0)
        ws = tuple(t._wq(gen, 8, *kn) for kn in ((h, inter), (h, inter), (inter, h)))
        bad = False
        cases = [(rows, torch.bfloat16) for rows in range(1, 9)] + [(3, torch.float32)]
        for rows, dtype in cases:
            x = torch.randn((rows, h), generator=gen, device="cuda")
            x = x.bfloat16() if dtype == torch.bfloat16 else x
            want = g8.mlp_gemv_int8_ref(x, *ws)
            got = g8.mlp_gemv_int8(x, *ws)
            tol = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
            if not (got.dtype == dtype and got.shape == want.shape
                    and torch.isfinite(got).all()):
                fails["finite_shape_dtype"] += 1
                bad = True
            r = _rel(got, want) / tol
            worst["rel_over_tol"] = max(worst["rel_over_tol"], r)
            if r > 1.0:
                fails["within_tol"] += 1
                bad = True
            if not torch.equal(g8.mlp_gemv_int8(x, *ws), got):
                fails["second_call_equal"] += 1
                bad = True
            if dtype == torch.bfloat16 and rows in (1, 8):
                got = g8.mlp_gemv_int8(x, *ws)
                for _ in range(22):
                    again = g8.mlp_gemv_int8(x, *ws)
                    if not torch.equal(again, got):
                        fails["repeat_calls_equal"] += 1
                        worst["repeat_max_abs_diff"] = max(
                            worst["repeat_max_abs_diff"],
                            (again.float() - got.float()).abs().max().item())
                        bad = True
            if rows in (1, 8) or dtype == torch.float32:
                n = t._kernels_per_call(lambda: g8.mlp_gemv_int8(x, *ws))
                kernels_seen.add(n)
                if n != (2 if dtype == torch.bfloat16 else 4):
                    fails["kernels_per_call"] += 1
                    bad = True
        if bad:
            failed_reps.append(rep)
    return {"shape": shape, "repeats": repeats, "failures": fails, "worst": worst,
            "kernels_per_call_seen": sorted(kernels_seen), "failed_repeats": failed_reps,
            "device": torch.cuda.get_device_name(0)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="h1152_i384", choices=list(t.MLP8_SHAPES))
    ap.add_argument("--repeats", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(json.dumps(repeat(args.shape, args.repeats)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
