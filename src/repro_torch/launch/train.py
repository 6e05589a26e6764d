"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

The port of the reference package's ``launch/train.py`` on one device:
the synthetic Markov-language pipeline (with the modality stubs of an
audio or vision arch), AdamW with ``min(20, steps)`` warmup steps and a
cosine decay over ``--steps``, a checkpoint every 50 steps into
``--ckpt-dir`` (and a restart from its newest one), and a line every 10
steps and at the last.  Random weights come from a generator seeded with
0 on the device.  It trains on the CUDA card and refuses to start without
one unless ``--device cpu`` is given; ``--reduced`` trains the
smoke-test sibling of the architecture.  ``--host-devices``,
``--data-axis`` and ``--model-axis`` (the reference's simulated mesh)
belong to the multi-GPU slice: any value but their default raises.
"""
import argparse


def main(argv=None, on_step=None):
    """Parse ``argv``, train, print the logged steps and return the
    trainer; ``on_step(trainer)`` runs after every step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size config (CPU-trainable)")
    ap.add_argument("--host-devices", type=int, default=0)
    ap.add_argument("--data-axis", type=int, default=0)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    mesh_flags = {"--host-devices": (args.host_devices, 0),
                  "--data-axis": (args.data_axis, 0),
                  "--model-axis": (args.model_axis, 1)}
    for flag, (value, default) in mesh_flags.items():
        if value != default:
            raise NotImplementedError(
                f"{flag} is not ported yet: it comes with the multi-GPU "
                f"slice (ROADMAP Queue 1 #8)")

    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import SyntheticLM, add_modality_stubs
    from repro_torch.models.model import build
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("repro_torch.launch.train: no CUDA device is "
                         "available (pass --device cpu to train on the CPU)")
    cfg = reduced_config(args.arch) if args.reduced else get_config(
        args.arch)
    lm = build(cfg)
    print(f"arch {cfg.arch_id}: ~{cfg.approx_params() / 1e6:.1f}M params "
          f"({cfg.active_params() / 1e6:.1f}M active) on {args.device}")

    data = SyntheticLM(cfg.vocab_size, args.seq, args.global_batch, seed=0)

    def batch_fn(step):
        return add_modality_stubs(data.batch_at(step), cfg, step)

    tc = TrainConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=50,
        log_every=10,
        opt=OptimizerConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                            total_steps=args.steps))
    gen = torch.Generator(device=args.device).manual_seed(0)
    tr = Trainer(lm, batch_fn, tc, generator=gen)
    if tr.step:
        print(f"resumed at step {tr.step}")
    hist = tr.run(on_step=on_step)
    for h in hist:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"lr {h['lr']:.2e}  gnorm {h['grad_norm']:.2f}")
    return tr


if __name__ == "__main__":
    main()
