"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Prefill + batched greedy (or sampled) decode with the ServeEngine on
random weights made from a seed.  It runs on the CUDA card and refuses to
start without one unless ``--device cpu`` is given; ``--reduced`` serves
the smoke-test sibling of the architecture.  ``--host-devices`` and
``--shard-kv-seq`` (the reference's simulated mesh and sequence-sharded
decode) belong to the multi-GPU slice and raise.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--host-devices", type=int, default=0)
    ap.add_argument("--shard-kv-seq", action="store_true")
    args = ap.parse_args(argv)
    if args.host_devices or args.shard_kv_seq:
        raise NotImplementedError(
            "--host-devices and --shard-kv-seq are not ported yet: they "
            "come with the multi-GPU slice (ROADMAP Queue 1 #8)")

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import add_modality_stubs
    from repro_torch.models.model import build
    from repro_torch.serve.engine import ServeEngine

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("repro_torch.launch.serve: no CUDA device is "
                         "available (pass --device cpu to serve on the CPU)")
    dev = torch.device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(
        args.arch)
    lm = build(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init(gen)

    max_len = cfg.vision_tokens + args.prompt_len + args.gen + 8
    eng = ServeEngine(lm, params, max_len=max_len)
    rng = np.random.default_rng(0)
    batch = {"inputs": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
        .astype(np.int64))}
    batch = {k: t.to(dev) for k, t in add_modality_stubs(batch, cfg).items()}
    out = eng.generate(batch, steps=args.gen, temperature=args.temperature,
                       generator=gen)
    print(f"arch {cfg.arch_id} on {dev}: generated {tuple(out.shape)} "
          f"tokens")
    for i, row in enumerate(out.cpu().tolist()):
        print(f"  req {i}: {row}")


if __name__ == "__main__":
    main()
