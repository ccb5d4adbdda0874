"""The data-parallel mesh on N cards against one process on one card.

    python -m mft_tpu_torch.parallel.multicard --ranks N

starts N processes, one a card (rank r on card r), in an NCCL group
(``tcp://localhost:<free port>``), each with ``make_mesh()``, and runs on
the mesh:

- one step of the frozen-BN model (batch norm on its running statistics,
  every parameter trained) and one of the full recipe (``RAFT(train_mode=
  True)``: batch statistics over the global batch through ``BatchNorm.mesh``)
  at the full recipe's width: a global batch of 8 at 368x768, 12
  iterations, bf16 compute over float32 parameters, the committed weights;
  then 3 more steps of each, timed;
- the batch norms' collectives alone: one all-reduce a layer and direction
  at the context encoder's widths, timed;
- ``StreamingTracker(default_config(), n_clips=8, mesh=)`` for
  ``--timesteps`` timesteps at 512x512 (synthetic clips), timed.

Every rank must hold the same parameters and statistics after the steps.
Rank 0 then repeats each step and the streaming in one process on card 0,
from the same weights and inputs, and prints the gaps and the times, one
line each, and a last line ``MULTICARD {json}``. With one rank every result
must be bit for bit the one-process result; with more, the gaps are printed
and held to ``GAP_LIMITS`` (a mean or sum taken wrongly over the ranks moves
them by orders of magnitude more). cuDNN runs deterministically
throughout. The command exits non-zero if a rank fails, a check fails or
the run outlasts ``TIMEOUT_S``; it stops every process it started.

``--device cpu`` runs the same on the CPU in a gloo group (the plain
versions; a rehearsal at a small ``--size``, ``--iters`` and
``--stream_size``).
"""

import argparse
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from mft_tpu_torch import ops

ROOT = Path(__file__).resolve().parents[2]
GLOBAL_BATCH = 8
CLIPS = 8
TIMED = 3                # timed steps after the compared first one
TIMEOUT_S = 1200
LOSS_KW = dict(gamma=0.85, freeze_optical_flow=False,
               occlusion_module="separate_with_uncertainty",
               uncertainty_loss_type="huber_non_occluded", optical_flow_loss_type="L1",
               weighting_unc_loss=False)
# with more than one rank: the loss's relative gap and the gradients' L2 gap
# over their L2 norm (bf16 compute: the global statistics sum in another
# order, which moves bf16 roundings; the ranks' batch slices take other cuDNN
# algorithms than the whole batch); a mean taken over the wrong count or a
# backward without its all-reduce moves them by far more
GAP_LIMITS = {"loss": 1e-2, "grad_l2": 0.1}
# conv biases that a norm follows: zero gradient in exact arithmetic (in the
# full recipe the context encoder's batch norms take batch statistics too)
BEFORE_NORM = re.compile(
    r"^(fnet|cnet)\.(conv1|layer\d_\d\.(conv1|conv2|downsample_conv))\.bias$")


def card_lines() -> list:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return [line.strip() for line in out.stdout.strip().splitlines()]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _batch(dev, n, size):
    from mft_tpu_torch.train import synth
    return tuple(torch.from_numpy(b).to(dev) for b in
                 synth.make_batch(np.random.default_rng(0), n, *size))


def _clip_frames(timesteps, S):
    """(timesteps + 1, CLIPS, S, S, 3) uint8 BGR: clip c a texture from seed
    c moving 2 px right and 1 px down a frame."""
    from mft_tpu_torch.train.synth import multiscale_texture
    frames = np.empty((timesteps + 1, CLIPS, S, S, 3), np.uint8)
    for c in range(CLIPS):
        tex = multiscale_texture(np.random.default_rng(c), S + timesteps + 2,
                                 S + 2 * timesteps + 2)
        for k in range(timesteps + 1):
            frames[k, c] = tex[timesteps - k:timesteps - k + S,
                               2 * (timesteps - k):2 * (timesteps - k) + S]
    return frames


def _steps(recipe, mesh, batch, iters, dev):
    """The first step's {'loss', 'grads', 'state', 'launches'}, the ms of
    the TIMED steps after it (each synchronised) and the model."""
    from mft_tpu_torch.config import SYNTH_WEIGHTS
    from mft_tpu_torch.models.raft import RAFT
    from mft_tpu_torch.models.raft.raft import RAFTParams
    from mft_tpu_torch.models.raft.wrapper import load_weights
    from mft_tpu_torch.train.loop import make_train_step
    from mft_tpu_torch.train.optim import make_optimizer
    model = RAFT(RAFTParams(occlusion_module="separate_with_uncertainty",
                            compute_dtype="float32"), train_mode=recipe == "full")
    model.load_state_dict(load_weights(Path(SYNTH_WEIGHTS)))
    model.to(dev).cast_per_call(torch.bfloat16)
    tx, _ = make_optimizer(lr=1.25e-4, num_steps=100)
    state = {"model": model, "opt_state": tx.init(dict(model.named_parameters())), "step": 0}
    step = make_train_step(model, tx, LOSS_KW, iters=iters, mesh=mesh)
    first, ms = None, []
    ops.reset_launch_counts()
    for k in range(1 + TIMED):
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["train/loss"])
        _sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
        if k == 0:
            first = dict(loss=loss, launches=ops.launch_counts(),
                         grads={n: p.grad.detach().clone() for n, p in model.named_parameters()},
                         state={n: v.detach().clone() for n, v in model.state_dict().items()})
    return first, ms[1:], model


def _same_on_every_rank(tensors, dev) -> bool:
    """Whether every rank holds bit for bit rank 0's tensors."""
    import torch.distributed as dist
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    ok = torch.tensor([int(torch.equal(ref, flat))], device=dev)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok.item())


def _bn_collectives_ms(mesh, widths, dev, reps=20) -> float:
    """ms of one step's batch-norm collectives: an all-reduce-mean of a
    (2, C) float32 tensor per batch norm of width C, forward then backward,
    as ``axis_mean`` issues them (CUDA events on the card, the host clock on
    the CPU)."""
    from mft_tpu_torch.parallel.mesh import all_reduce_mean
    bufs = [torch.zeros(2, c, device=dev) for c in widths]

    def once():
        for b in bufs + bufs[::-1]:
            all_reduce_mean([b], mesh)
    once()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            once()
        return 1e3 * (time.perf_counter() - t0) / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(reps):
        once()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def _stream(mesh, frames, dev):
    """The last timestep's (flow, occlusion, sigma) of this process's clips,
    the median ms of the timesteps after the first, the number of clips
    and the kernel launches a timestep."""
    from mft_tpu_torch.config import default_config
    from mft_tpu_torch.parallel import StreamingTracker
    st = StreamingTracker(default_config(), n_clips=CLIPS, mesh=mesh, device=dev)
    st.init(frames[0])
    ms = []
    ops.reset_launch_counts()
    for k in range(1, len(frames)):
        _sync(dev)
        t0 = time.perf_counter()
        r = st.track(frames[k])
        _sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = {k: n / (len(frames) - 1) for k, n in ops.launch_counts().items()}
    return (r.flow, r.occlusion, r.sigma), float(np.median(ms[1:] or ms)), st.local_clips, launches


def _nonzero(counts) -> dict:
    return {k: v for k, v in counts.items() if v}


def _gaps(mesh_res, one_res):
    """The loss's relative gap; the gradients' L2 gap over their L2 norm,
    all tensors together, and the largest gap of a tensor over its largest
    |gradient| (biases a norm follows aside); the largest state gap over its
    tensor's largest |value|; bit-identical counts."""
    lm, gm, sm = (mesh_res[k] for k in ("loss", "grads", "state"))
    lo, go, so = (one_res[k] for k in ("loss", "grads", "state"))
    diff = math.sqrt(sum(float((gm[n] - go[n]).double().square().sum()) for n in go))
    norm = math.sqrt(sum(float(go[n].double().square().sum()) for n in go))
    grads_equal = sum(torch.equal(gm[n], go[n]) for n in go)
    state_equal = sum(torch.equal(sm[k], so[k]) for k in so)
    return dict(
        loss=lm, loss_one=lo, loss_gap=abs(lm - lo) / max(abs(lo), 1e-30),
        grad_l2=diff / max(norm, 1e-30),
        grad_gap=max(float((gm[n] - go[n]).abs().max()) / max(float(go[n].abs().max()), 1e-30)
                     for n in go if not BEFORE_NORM.match(n)),
        state_gap=max(float((sm[k].float() - so[k].float()).abs().max())
                      / max(float(so[k].float().abs().max()), 1e-30) for k in so),
        grads_equal=grads_equal, grads=len(go), state_equal=state_equal, states=len(so),
        bit_for_bit=lm == lo and grads_equal == len(go) and state_equal == len(so))


def rank_main(args):
    """One rank's run; rank 0 also runs the one-process references and
    prints. returns the exit code."""
    import torch.distributed as dist
    from mft_tpu_torch.models.raft.layers import BatchNorm
    from mft_tpu_torch.parallel.mesh import make_mesh
    rank, ranks, batch_size = args.rank, args.ranks, GLOBAL_BATCH
    cuda = args.device == "cuda"
    if cuda:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{args.port}", world_size=ranks,
                            rank=rank)
    size = tuple(args.size)
    mesh_res, mesh_ms = {}, {}
    try:
        mesh = make_mesh()
        batch = _batch(dev, batch_size, size)
        for recipe in ("frozen", "full"):
            mesh_res[recipe], mesh_ms[recipe], model = _steps(recipe, mesh, batch, args.iters,
                                                              dev)
            state = model.state_dict()
            mesh_res[recipe]["same"] = _same_on_every_rank([state[k] for k in sorted(state)],
                                                           dev)
            widths = [m.weight.numel() for m in model.cnet.modules() if isinstance(m, BatchNorm)]
            del model, state
        bn_ms = _bn_collectives_ms(mesh, widths, dev)
        frames = _clip_frames(args.timesteps, args.stream_size)
        out, stream_ms, local, stream_launches = _stream(mesh, frames, dev)
        # every rank's clips to rank 0, and the slowest rank's ms
        gathered = []
        for x in out:
            parts = [torch.empty_like(x) for _ in range(ranks)]
            dist.all_gather(parts, x.contiguous())
            gathered.append(torch.cat(parts))
        slow = torch.tensor([stream_ms], device=dev)
        dist.all_reduce(slow, op=dist.ReduceOp.MAX)
        stream_ms = float(slow.item())
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return 0

    cards = card_lines() if cuda else ["cpu"]
    card = cards[0]
    backend = "NCCL" if cuda else "gloo"
    print(f"multicard: {ranks} rank(s), cards (nvidia-smi name, power limit): "
          f"{'; '.join(cards[:ranks])}", flush=True)
    ok = True
    summary = {"ranks": ranks, "device": args.device, "cards": cards, "batch": batch_size,
               "size": list(size), "iters": args.iters}
    for recipe in ("frozen", "full"):
        one, one_ms, model = _steps(recipe, None, batch, args.iters, dev)
        del model
        g = _gaps(mesh_res[recipe], one)
        same = mesh_res[recipe]["same"]
        name = {"frozen": "frozen-BN step (running statistics)",
                "full": "full-recipe step (batch statistics over the global batch)"}[recipe]
        print(f"multicard: {ranks} rank(s) ({backend}), {name}, global batch {batch_size} at "
              f"{size[0]}x{size[1]}, {args.iters} iterations, bf16 over f32, deterministic "
              f"cuDNN: loss {g['loss']:.6f} vs {g['loss_one']:.6f} in one process "
              f"(relative gap {g['loss_gap']:.3e}); gradients: L2 gap {g['grad_l2']:.3e} of "
              f"their L2 norm, largest gap {g['grad_gap']:.3e} of a tensor's largest "
              f"|gradient|, {g['grads_equal']} of {g['grads']} "
              f"bit-identical; after the update largest gap {g['state_gap']:.3e}, "
              f"{g['state_equal']} of {g['states']} tensors bit-identical; every rank holds "
              f"the same parameters and statistics: {same}; launches of the first step "
              f"{_nonzero(mesh_res[recipe]['launches'])}; step ms (median of {TIMED} after "
              f"the first) {ranks} rank(s) {np.median(mesh_ms[recipe]):.1f} "
              f"({', '.join(f'{m:.1f}' for m in mesh_ms[recipe])}), one process "
              f"{np.median(one_ms):.1f} ({', '.join(f'{m:.1f}' for m in one_ms)}) [{card}]",
              flush=True)
        ok &= same and math.isfinite(g["loss"])
        if ranks == 1:
            ok &= g["bit_for_bit"]
        else:
            ok &= (g["loss_gap"] <= GAP_LIMITS["loss"]
                   and g["grad_l2"] <= GAP_LIMITS["grad_l2"])
        summary[recipe] = dict(g, same_on_every_rank=same, ms=float(np.median(mesh_ms[recipe])),
                               ms_one=float(np.median(one_ms)),
                               launches=mesh_res[recipe]["launches"])
    print(f"multicard: batch-norm collectives, {2 * len(widths)} all-reduces of (2, C) "
          f"float32 a step ({len(widths)} batch norms, forward and backward): {bn_ms:.3f} ms "
          f"a step over {ranks} rank(s) (20 steps' worth) [{card}]", flush=True)
    summary["bn_collectives_ms"] = bn_ms
    one_out, one_ms, _, _ = _stream(None, frames, dev)
    flow_gap = (gathered[0] - one_out[0]).norm(dim=-1)
    equal = all(torch.equal(a, b) for a, b in zip(gathered, one_out))
    S = args.stream_size
    print(f"multicard: streaming, default_config(), {CLIPS} clips at {S}x{S} ({local} a rank), "
          f"{args.timesteps} timesteps: flow gap to one process median "
          f"{float(flow_gap.median()):.4f} px, largest {float(flow_gap.max()):.4f} px, bit for "
          f"bit: {equal}; launches a timestep on rank 0 {_nonzero(stream_launches)}; ms a "
          f"timestep (median after the first, slowest rank) "
          f"{stream_ms:.2f} on {ranks} rank(s), {CLIPS * 1e3 / stream_ms:.2f} clip-frames/s; "
          f"one process {one_ms:.2f} ms, {CLIPS * 1e3 / one_ms:.2f} clip-frames/s [{card}]",
          flush=True)
    summary["stream"] = dict(ms=stream_ms, clip_fps=CLIPS * 1e3 / stream_ms, ms_one=one_ms,
                             clip_fps_one=CLIPS * 1e3 / one_ms, bit_for_bit=equal,
                             launches=stream_launches,
                             gap_median=float(flow_gap.median()), gap_max=float(flow_gap.max()))
    ok &= bool(torch.isfinite(gathered[0]).all())
    if ranks == 1:
        ok &= equal
    summary["ok"] = bool(ok)
    print("MULTICARD " + json.dumps(summary), flush=True)
    return 0 if ok else 1


def launch(args) -> int:
    """Start the ranks, relay rank 0's output, wait; returns the exit code
    (non-zero if any rank failed or the run outlasted ``TIMEOUT_S``)."""
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"multicard: {args.ranks} ranks need {args.ranks} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    if args.device == "cuda":   # one build for every rank, before they start
        from mft_tpu_torch.ops import _build
        _build.build()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    argv = [sys.executable, "-m", "mft_tpu_torch.parallel.multicard", "--ranks",
            str(args.ranks), "--port", str(port), "--timesteps",
            str(args.timesteps), "--device", args.device, "--size", *map(str, args.size),
            "--iters", str(args.iters), "--stream_size", str(args.stream_size)]
    env = dict(os.environ, OMP_NUM_THREADS="1") if args.device == "cpu" else None
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        try:
            for r in range(args.ranks):
                log = None if r == 0 else open(Path(tmp) / f"rank{r}.log", "w")
                logs.append(log)
                procs.append(subprocess.Popen(argv + ["--rank", str(r)], cwd=ROOT, env=env,
                                              stdout=log,
                                              stderr=subprocess.STDOUT if log else None))
            deadline = time.monotonic() + TIMEOUT_S
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            print(f"multicard: the ranks outlasted {TIMEOUT_S} s", file=sys.stderr)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs[1:]:
                log.close()
        codes = [p.returncode for p in procs]
        for r, code in enumerate(codes):
            if code and r:
                tail = (Path(tmp) / f"rank{r}.log").read_text()[-4000:]
                print(f"multicard: rank {r} exited {code}:\n{tail}", file=sys.stderr)
        return next((c for c in codes if c), 0)


def get_parser():
    ap = argparse.ArgumentParser(description="the data-parallel mesh on N cards against "
                                             "one process on one card")
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--size", type=int, nargs=2, default=[368, 768])
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--timesteps", type=int, default=4)
    ap.add_argument("--stream_size", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (NCCL, a card a rank) or 'cpu' (gloo, the plain versions)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    if GLOBAL_BATCH % args.ranks or CLIPS % args.ranks:
        raise SystemExit(f"--ranks {args.ranks} must divide the global batch of "
                         f"{GLOBAL_BATCH} and the {CLIPS} clips")
    if args.device not in ("cuda", "cpu"):
        raise SystemExit(f"unsupported --device {args.device}")
    if args.rank is None:
        return launch(args)
    return rank_main(args)


if __name__ == "__main__":
    sys.exit(main())
