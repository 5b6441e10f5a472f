"""chip_smoke.py's serving phases alone, on random dictionaries and a random
subject, without the kernel build or the training phases before them.

    python scripts/serve_chip.py [encode] [http] [drain] [--after-profiler]

Exports 16 seeded random TiedSAE dicts of the harvest sweep's shape (D 512,
N 4096) to a temporary directory, makes the rows and token pools from a
seeded random Pythia-70M (`chip_smoke.serve_rows_pool`; no pretraining), and
runs the phases named (all three by default), printing chip_smoke's JSON
lines. ``--after-profiler`` first runs one `torch.profiler` session over a
few matmuls, as chip_smoke's traced phases do before serving, so the
dispatch times show what an earlier profiler session leaves behind. Needs a
CUDA device.
"""

import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("serve_chip: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from sparse_coding__tpu_torch.data.synthetic_text import TrigramLanguage
    from sparse_coding__tpu_torch.lm import config_for, init_params
    from sparse_coding__tpu_torch.models.learned_dict import TiedSAE
    from sparse_coding__tpu_torch.train.checkpoint import save_learned_dicts

    if "--after-profiler" in argv:
        x = torch.randn(1024, 1024, device="cuda")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            for _ in range(10):
                x = x @ x / 32
            torch.cuda.synchronize()
    cfg = config_for(cs.SUBJECT["model"])
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    lang = TrigramLanguage(cfg.vocab_size, seed=cs.SUBJECT["lang_seed"])
    with tempfile.TemporaryDirectory(prefix="sc_serve_chip_") as root:
        root = Path(root)
        g = torch.Generator(device="cuda").manual_seed(0)
        n_dict = cs.HARVEST["ratio"] * cfg.d_model
        lds = [TiedSAE(torch.randn(n_dict, cfg.d_model, generator=g, device="cuda") * 0.05,
                       torch.randn(n_dict, generator=g, device="cuda") * 0.01) for _ in range(16)]
        export = root / "learned_dicts.pkl"
        save_learned_dicts(export, [(ld, {"i": i}) for i, ld in enumerate(lds)])
        rows_pool, tokens = cs.serve_rows_pool(torch, cfg, params, lang)
        phases = [a for a in argv if not a.startswith("--")] or ["encode", "http", "drain"]
        for name in phases:
            t0 = time.perf_counter()
            if name == "encode":
                cs.phase_serve_encode(torch, export, rows_pool)
            elif name == "http":
                cs.phase_serve_http(torch, export, cfg, params, rows_pool, tokens)
            elif name == "drain":
                cs.phase_serve_drain(torch, root, export, rows_pool, tokens)
            else:
                raise SystemExit(f"unknown phase {name!r}")
            print(f"serve_chip: {name} {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
