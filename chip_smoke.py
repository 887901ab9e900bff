#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout (the port's package sits beside this
script). It needs one CUDA card and takes no arguments. Phases, each of
which raises on failure (exit code not 0, no result line):

1. the card: name and power limit, as nvidia-smi reports them; kernels
   K1, K2, K4 and K3 (CUDA C++, `csrc/cross_entropy.cu`,
   `csrc/flash_attention.cu`, `csrc/conv_backward.cu` and
   `csrc/decode_attention.cu`), K2's 3xTF32 instance
   (`csrc/flash_attention_tf32.cu`) and K4's TF32 instance
   (`csrc/conv_backward_tf32.cu`) start building from the checkout in the
   background, one nvcc each, all at once;
2. kernel K1's forward and backward (once K1 is built) against their
   plain PyTorch versions on the card: f32 at the ResNet shape
   (256, 1000) and at (4096, 32000), bf16 at the LM shape (8192, 32768),
   with labels -1 and C and tied rows, the forward's loss, correct and
   logsumexp, the backward on the gradient of a mean (a stride-0 g);
   times each kernel, its plain version and the library call
   (`F.cross_entropy`, and its backward through autograd; a yardstick
   only: the port never calls it);
3. one small ResNet-18 train step on the card (through K1) against the
   same step on the CPU (K1's plain version), from one set of weights;
4. kernel K2 against its plain version on the card, forward and
   backward: the LM's (8, 1024, 12, 64) bf16 causal in both layouts, a
   ragged (2, 1000, 4, 64) causal and a (2, 512, 4, 128) full, and the
   worked example's (32, 1024, 12, 64) causal (phase 34); times the
   forward, the backward and the two together for the kernel, the plain
   version and `F.scaled_dot_product_attention` (a yardstick only),
   and prints the forward's and the backward's time over SDPA's;
5. two bf16 LM train steps (2 layers, 2 heads of 64, seq 128, vocab 512)
   on the card (K1 and K2) against the same steps on the CPU (the plain
   versions), from one set of weights;
6. the ResNet-50 main path: the training benchmark at full width (batch
   256, 224x224 bf16 images, 1000 classes), with K1's launches counted
   around it;
7. the LM main path: the LM training benchmark at its published widths
   (12 layers, 12 heads, embed 768, vocab 32768, seq 1024, batch 8, bf16),
   10 steps a window, with K1's and K2's launches and K2's input copies
   counted around it (the qkv views are read in place: 0 copies); then
   K2's backward device time by kernel (the rows pre-pass, dK/dV, dQ;
   torch.profiler) at the shapes of 4, profiled only now so that no
   profiler session comes before the host-bound LM step;
8. kernel K4 (the fused 1x1-conv backward) against its plain version on
   the card at the 12 stride-1 1x1 shapes of ResNet-50 at batch 256,
   bf16; times the kernel, the plain version and cuDNN's
   `convolution_backward` on the same channels_last tensors (a yardstick
   only), with the kernel's time over cuDNN's at each shape and its
   device time by kernel (dgrad, wgrad, reduction; torch.profiler), and
   sums calls x time per step against the summed bound and cuDNN's sum;
9. two bf16 steps of a small bottleneck ResNet with `fused_1x1_bwd` and
   `fast_pool_bwd` on the card (K1, K4) against the same steps on the CPU
   (the plain versions), from one set of weights;
10. the ResNet-50 fused path: the training benchmark as in 6 with
   `fused_1x1_bwd`, with K1's and K4's launches and K4's layout copies
   counted around it; its FLOP count must equal the default path's, and
   its step is printed beside the default path's;
11. kernel K3 (the int8-KV decode attention, `csrc/decode_attention.cu`)
   against its plain version on the card: the dense `generate` shape
   (8, 12, 640, 64) `blhd` bf16 at pos 0, 127 and 639, a (4, 512, 12, 64)
   cache with per-slot positions, a 5-query verify window, head_dim 16
   (the drafter) and 128, and a head-major `bhld` case; the same engine
   shapes on a paged pool read through page tables (the engine's own
   calls); one query over 65,536 positions; the worked example's batch 1
   over a 1024-position cache at pos 64 and 190 (phase 34); each with q
   in its dtype and in f32; times the kernel and the plain version (no PyTorch call
   computes this function, so there is no library time) and one launch's
   floor (a one-element fill), printed beside K1's (256, 1000) and K3's
   pos-0 times;
12. decode card against CPU on one set of weights: greedy `generate` with
   the int8 cache on f32 and bf16 2-layer LMs (2 heads of 64, vocab 512),
   tokens equal on f32, the logits of every decode step within the stated
   tolerance, the top-2 margin printed; and a small f32 `SlotEngine` with a
   drafter and the int8 cache, tokens equal;
13. the decode main path: `benchmarks.decode.run_benchmark` at its
   defaults (12 layers, 12 heads of 64, embed 768, vocab 32768, bf16,
   batch 8, prompt 128) cut to 64 new tokens and one timed call after
   the first, with the bf16 cache, the int8 cache, and int8 weights with
   the int8 cache, with K3's launches counted around each (exactly
   num_layers x 63 a call with the int8 cache, 0 with the bf16 cache);
   before it, one decode forward of that
   model with each cache: its wall time and the card's busy time by
   operator, K3's row of which is printed beside each int8 run;
14. the serving main path: `run_engine_benchmark` at the LM's full width
   with the int8 cache (cold, warm, spec_base, spec), with K3's launches
   counted around it: cold equals warm, spec equals spec_base, every
   timed request hits the prefix store, none re-prefills the prefix;
15. one engine decode step at that shape (4 slots of 512, pages of 16, 4
   requests of 256 prompt tokens) profiled with torch.profiler: K3's and
   the page gathers' (`aten::index`) device ms and calls a step. With
   `--engine-step` this phase runs alone, on the package beside the
   script;
16. (after 5) two bf16 steps of a small MoE LM (2 layers, 2 heads of 64,
   seq 128, vocab 512, its second block 4 experts, k = 2, capacity factor
   0.5) on the card (K1, K2) against the CPU (the plain versions), with
   the top-k choices the capacity dropped counted and printed; then two
   bf16 steps of a small ViT (2 layers, 2 heads of 64, 32x32 images,
   patch 8, 10 classes) the same way, with dense attention and with
   `flash_attention`;
17. (in 4) K2 at ViT-S/16's attention, (256, 197, 6, 64) bf16
   non-causal: forward and backward against the plain version, timed
   beside the plain version and SDPA, with its bound;
18. (after 7) the ViT main path: the image benchmark with
   model_name="vit" at ViT-S/16's configuration (batch 256, 224x224, 1000
   classes, dense attention as in the reference: 1 K1 launch a step, no
   K2), then the same step with `flash_attention` (12 K2 forward and 12
   backward launches a step, 0 copies of the qkv views), its step beside
   the dense one's and the first step's loss of both;
19. the MoE LM main path: the LM benchmark at its published widths with
   every second block a mixture of 8 experts (k = 2, capacity factor
   1.25): K1 once a step, K2 12 + 12 a step, the router loss of the last
   step;
20. checkpoint and resume: a small MoE LM through the LM benchmark, 6
   steps straight against 3 with `checkpoint_dir` and 3 more in a fresh
   process that restores them (parameters and momentum bit-equal), then
   a torn step 6 that a restore must skip for step 3; restore_seconds;
21. where a ViT-S/16 step and a MoE LM step go on the card
   (torch.profiler, by operator; for the MoE LM, the expert products'
   and the dispatch and combine products' shares); then the LM step of 7:
   its card time, K1's forward and backward shares of it and its peak
   memory (with `--lm-step-profile` this runs alone, on the package
   beside the script);
22. (after 20) the mesh at a world of one over NCCL: a process group of
   one rank from a FileStore and `make_mesh()` (1, 1, 1, 1) on the card;
   the LM of 7 and ResNet-50 with `fused_1x1_bwd` each take a first step
   on the mesh (the gradient all_reduce made) from their default
   weights, held against the single-device step from the same weights:
   equal to the bit, or the largest difference and the single-device
   step's own run-to-run difference; the reduction's own time; then both
   benchmarks' mesh paths with K1's, K2's and K4's launches counted
   around each; ring attention and the vocab-parallel loss at n = 1 on
   CUDA tensors against their plain versions;
23. two processes on the one card over gloo, data parallel: the LM at
   global batch 8 (4 a rank) and ResNet-50 with `fused_1x1_bwd` at 256
   (128 a rank, BatchNorm over the global batch), each rank's first step
   against this process's step on the whole batch, then the step's wall
   time and the gloo all_reduce's share, as two processes sharing one
   card (not a two-card number);
24. (after 21) the pipeline at a world of one over NCCL: the pipelined LM
   (`parallel/pipeline.create_pp_lm_state` and `make_pp_lm_train_step`)
   at the LM's published widths on the (1, 1, 1, 1) mesh in 4
   microbatches; its first update against the dense single-device step's
   from the same weights, as a relative norm within `VIT_UPDATE_REL`;
   K1 once and K2 48 + 48 times in the step, at (2, 1024, 12, 64) (K2 at
   that shape against its plain version in 4); both steps' host-clock
   times;
25. the MoE LM at the published widths (every second block 8 experts) on
   that mesh: its first step with `seq_axis="model"` (one shard, the
   slot offsets from an all_gather of one) equal to the bit to the step
   without a sequence axis;
26. decode over the mesh: `benchmarks.decode.run_benchmark` as in 13
   with the int8 cache on that mesh, its tokens equal to phase 13's
   single-device run's, K3 counted; then two processes sharing the card
   over gloo, 4 of 8 streams each, 64 new tokens, each rank's tokens equal to this process's
   `generate` of its 4 rows (K3 at a rank's (4, 12, 192, 64) against its
   plain version in 11); tokens/s as two processes sharing one card, not
   a two-card rate; then the same two processes sampled at temperature
   1.5, each rank's tokens equal to its rows of this process's run on all
   8 streams with the same seed;
27. (after 26) the elastic trainer at full width: `parallel/elastic
   .ElasticTrainer` drives the LM of 7 on a one-rank mesh over NCCL,
   with a real `TrainCheckpointer`; a scripted fleet status bumps the
   generation 1 -> 2 at step 3 of 6, and the trainer flushes, leaves the
   group, forms a new one, rebuilds and restores: one resume, 0 steps
   lost, acks notified -> resumed, the final parameters and momentum
   bit-equal to an uninterrupted 6-step run, K1 6 and K2 72 + 72 times;
   the step, save, restore and reconfigure seconds;
28. the SIGKILL drill: two processes of `python -m
   tritonk8ssupervisor_tpu_torch.cli.main train --device cuda --backend
   gloo` on the card (NCCL refuses two ranks on one card), coordinates
   from the `JAX_*` env contract; process 1 SIGKILLed as a process group
   after the first committed checkpoint; once the survivor acknowledges
   notified, the fleet status says generation 2 with slice 1 degraded
   and the env file names one process; the survivor must rejoin at
   world size 1, restore the state the two saved, and reach step 400
   having lost at most 25 steps; the seconds from the kill to its
   notified ack and to its resume;
29. the serving plane at full width: a `Gateway` over a `SlotEngine` of
   the LM at its published widths (512 positions, pages of 16, 4 slots,
   the int8 cache) with the engine benchmark's drafter (spec_k 4; not its
   shared head bias), its request journal and spans fsync'd in a
   temporary workdir as `cli.main serve` wires them; the prefix store
   seeded by one warm-up request; `server.run_drill` with 16 requests of
   64-256 prompt tokens opening with 48-192 tokens of a shared 192-token
   prefix, 32 new tokens each at temperature 0,
   with K3 counted around it, each request's tokens equal to a fresh
   engine's with the prompts run one at a time; then the analyzers over
   the drill's span log and journal: `cli.main trace KEY --json` of each
   of the 16 keys exits 0, complete, with this process as its only
   writer and queue-wait + prefill + decode equal to the key's latency
   (1e-5 s), the drill keys' `prefill-chunk` spans carry the tokens the
   engine prefilled, `trace` of an unknown key exits 2, and `python -m
   ...cli.main analyze --correlate --json` counts 16 completions and no
   ledger record; then `make_handler` on a
   ThreadingHTTPServer on port 0 (/healthz 200, a plain and a streamed
   /generate equal to the engine alone, 400 for an over-long prompt,
   /metrics); a gateway restarted on the journal answering a completed
   key `replayed` with its tokens and no engine step; `cli.main serve
   --drill 8` on the card. It fails on an engine crash (the loop's
   `crashed`, the `serving_engine_crashed` gauge), an expiry or a
   requeue. It prints the drill's p50 and p99 latency, tokens/s, TTFT,
   the engine-step histogram's count and mean, the span count and K3's
   launches. With `--serving-plane` this phase runs alone;
30. the gateway fleet at full width: `serving/fleet.GatewayFleet` with two
   replicas over two `SlotEngine`s as in 29 (one set of weights, a KV
   pool each, slice leases on the fsync'd event ledger, journal shards
   fsync'd), driven by `drive_fleet` on a wall clock: 8 keyed greedy
   requests, then 16 more (prompts of 64-256 tokens from seed 30, sharing
   no prefix, 32 new tokens each), replica g1 killed at the first step
   boundary at which it holds an in-flight slot and a queued key and
   revived a few seconds later as a standby, and 4 duplicates of
   first-wave keys resubmitted. It fails unless every key settles
   exactly once and none expires, `ServeInvariantChecker.check_fleet`
   over the shards and the ledger finds nothing, the successor's
   adoption re-admitted at least one key, the duplicates are answered
   from the journal with no engine step, every key's tokens equal a
   fresh engine's, g1's slices are revoked and granted again at higher
   epochs, the reassignment comes within one fleet tick and one drive
   pass of the kill, and `cli.main status --json --all` exits 0 with the
   ledger's grant and revoke counts. Then the port's
   `provision/autoscale.read_fleet_demand` over the workdir must merge
   both replicas' `demand-signal-<replica>.json` shards into the signal
   `merge_demand_signals` makes of each shard read alone, its queue depth
   and service rate the sums of what the replicas published. It prints
   p50 and p99 latency, TTFT, tokens/s, kill-to-reassignment, keys redone
   and K3's launches. With `--gateway-fleet` this phase runs alone;
31. a maintenance drain of the LM at its published widths: the port's
   watchdog (`provision/maintenance.watch`, a thread polling every 0.05
   s a scripted metadata key: NONE, then TERMINATE_ON_HOST_MAINTENANCE
   from the run's first committed checkpoint until it exits, then NONE)
   drains `python -m ...benchmarks.lm --steps 20 --warmup 1 --windows 3
   --checkpoint-dir D` at a window boundary; the run must exit 0 with
   the event as its `drained` reason, before its last window, its last
   step committed; the watchdog removes the drain file once the event
   clears; the same command resumes from that step and finishes
   undrained; a straight run to the same step (its windows, run as one,
   and warm-up derived from the two reports) must restore bit-equal,
   parameters and momentum. K1's and K2's launches are counted in the three runs'
   processes. Then `python -m ...provision.maintenance --once` with its
   fetch sent to a closed local port exits 0 and writes no drain file.
   It prints the windows before the drain, the drain's latency from the
   event to the run's exit, the save and restore seconds and each run's
   step time. With `--maintenance-drain` this phase runs alone;
32. the shipped workload: the port's compiler (`config/compile
   .write_manifests`) compiles the benchmark Job set of a one-host GKE
   config (v5e 2x2) twice, for the LM (10 steps a window, 2 windows, a
   checkpoint directory) and for ResNet-50 with `--fused-1x1-bwd` (5
   steps a window, 2 windows); the written YAML is read back: the
   ConfigMap's archive must equal `packaging.build_archive_bytes()`,
   carry the four CUDA sources and no `csrc/build/` member, and the
   ConfigMap must stay under the API server's 1 MiB object limit. The
   archive is installed as the Job installs it (`pip install
   --no-build-isolation --no-deps --target`, offline; the TPU host's
   jax[tpu] pin is the TPU Job's and is not installed here), and each
   Job's workload, the part of its container command after `&&`, runs
   in a fresh process in a temporary directory with only the installed
   tree on PYTHONPATH and the Job's env (each fieldRef read as pod 0):
   it must exit 0 with its JSON report, import the installed package,
   build K1 and K2 (LM) or K4 (ResNet-50; K1 is the LM Job's) with nvcc
   from the installed sources into the installed `csrc/build/`, launch
   K1's forward and backward once a step and K2 12 + 12 times a step (LM)
   or K4 33 times a step (ResNet-50), and the LM must
   leave a committed checkpoint step. It prints the archive's and the
   ConfigMap's bytes, the install and build seconds, each run's step
   time and rate, and the launches. With `--shipped-workload` this phase
   runs alone;
33. the supervised elastic co-drive: the port's `Supervisor` ticks on a
   virtual clock (`SimClock`) in its own thread over a scripted fleet of 4
   slices (`SuperviseSim`; a tick every 30 s, flap threshold 2), and slice 3
   is preempted at t = 200 s; the port's `ElasticTrainer` trains the LM of 7
   on a one-rank NCCL group for 24 steps, each a real LM step (K1, K2), then
   13 virtual seconds and the fleet's down check, with a real checkpoint
   every 4 steps, reading the supervisor's fleet-status.json and
   acknowledging through job-ack.json. It must see one scoped heal, of
   slice 3 alone, at most one checkpoint interval of steps lost,
   job-notified then job-resumed with an MTTR on the ledger, final
   parameters and momentum equal to an uninterrupted run's to the bit, and
   K1 once and K2 12 + 12 times for every step run (replayed steps
   included). It prints the virtual time to training resumed, the steps
   lost, the phase's wall seconds and the LM's step ms. With
   `--supervised-elastic` this phase runs alone;
34. the worked example of docs/detailed.md ("Training on real text") at
   its widths: the bytes of docs/*.md through `utils/corpus.ByteTokenizer`
   and `train_val_split(val_fraction=0.1)`, a `TransformerLM` of 12
   layers, 12 heads, embed 768, vocab 256, seq 1024 (bf16, flash
   attention) at batch 32 trained by `lm_optimizer(3e-4)` on a one-rank
   NCCL mesh from `corpus.batches` through `utils/data.prefetch_to_mesh`,
   60 steps with warm-up 20 and decay 200 (the example's 500 and 20,000
   cut to fit the whole script's time limit); the mean loss of the last 10 steps below
   the first 10's, the held-out loss of `make_lm_eval_step` falling, its
   perplexity below 256; K1 once each way and K2 12 + 12 times a train
   step, K1's forward once and K2 12 times an eval call; then greedy
   `models/decode.generate`
   of 128 tokens from a 64-byte held-out prompt (the first capitalised
   held-out line of 64 bytes or more) with the default cache and the
   int8 cache (K3 exactly 12 x 127 times), both decodable and not one
   repeated byte; the int8 cache's logits of those 128 steps, fed the
   int8 output, through K3 and then with K3's plain version in its place,
   within 2^-5 of the largest logit; K1's forward and backward at the
   path's (32768, 256) bf16 against their plain versions, `F.cross_entropy`
   and their bounds (K2 at its
   (32, 1024, 12, 64) and K3 at its (1, 12, 1024, 64) are checked in 4
   and 11); and `python -m
   ...benchmarks.containerbench --json` at its defaults, printed as the
   card machine's host numbers. It prints the step ms and tokens/s, the
   losses and perplexity, the decode ms a token with each cache, the
   launches and the phase's wall seconds. With `--worked-example` this
   phase runs alone;
35. provisioning through the wizard, the compiled LM Job on the card and
   its roofline: in a stub world (`gcloud`, `terraform`, `kubectl`, `ssh`,
   `ssh-keygen` and `ansible-playbook` as `sh` scripts on PATH, standing
   in for the cloud, never for the card), the port's `cli.main` with no
   command and the wizard's answers for a GKE cluster of one v5e 2x2
   slice, `--bench-workload lm` and phase 32's LM flags plus `--profile
   DIR`: "Cluster is ready", the config, hosts.json and the three
   manifests, a compacted journal; a second run that resumes with every
   task skipped; `--show-config`'s rows; `-c --yes`, after which the state
   is gone. Then the bench Job's workload, read from the manifests
   provisioning wrote, runs on the card from the checkout (the LM at the
   reference's widths: 12 layers, 12 heads of 64, embed 768, vocab 32768,
   seq 1024, batch 8) with K1's and K2's launches counted by phase 32's
   `runpy` wrapper: K1 once each way and K2 12 + 12 times a step. Last
   `python -m tritonk8ssupervisor_tpu_torch.utils.roofline DIR --json`
   over the Job's profile, and its text report through the same `main`
   in this process, printed; the roofline's device time
   within 2% of the profile's busy time, K1's forward operator's bytes
   exactly its cost function's at (8192, 32768) bf16, K2's FLOPs exactly
   12 times its formulas' at (8, 1024, 12, 64) causal, no kernel above
   105% of the tensor-core peak, and none above 105% of the memory peak
   but those whose traffic a call fits in the L2 (printed). With
   `--provision-roofline` this phase runs alone;
36. the GPU cluster plane: in phase 35's stub world with GPU answers
   (`gcloud compute instances list` names the host RUNNING, `kubectl`
   reports allocatable `nvidia.com/gpu`), `cli.main --accelerator gpu`
   through the wizard for `gke-gpu` (with `--probe`) and `gpu-vm`, each an
   h100 1x1 slice with phase 32's LM flags: terraform applied in the
   mode's module, the GPU playbook, the tfvars and ansible vars equal to
   the compiler's, no TPU or JAX string in any GPU document; `-c --yes`
   destroys each module's state. Then on the card, from an offline
   install of the gke-gpu ConfigMap's archive: the probe Job's
   `gpu_smoke_command` (the gpu-vm vars' `gpu_smoke_cmd` is held byte-equal
   to it and not started again) and the vars' `cluster_smoke_cmd` (an
   NCCL group at a world of one under `python -m torch.distributed.run`),
   each printing its OK line; and the compiled
   gke-gpu LM Job's command with the Service's hostname read as
   127.0.0.1 and `JOB_COMPLETION_INDEX=0`: the launcher starts the LM at
   the reference's widths, K1 and K2 are built by nvcc from the installed
   sources, and phase 32's `runpy` wrapper counts K1 once each way and K2
   12 + 12 times a step. It prints the step ms and the launcher's
   start-up seconds. With `--gpu-plane` this phase runs alone;
37. every head_dim: K2 against its plain version, forward and backward,
   at (8, 1024, 8, 96), (8, 1024, 24, 32) and (8, 1024, 3, 256) causal
   bf16 (the LM benchmark with 8, 24 and 3 heads), Phi-2's (8, 1024, 32,
   80) causal, a ragged (2, 1000, 4, 40) and a padded (2, 1000, 4, 36)
   full, and (2, 512, 2, 256) fp16 bhsd full, each timed beside SDPA; K3
   against its plain version at head_dim 40 and 72 (dense and paged) and
   256; the LM benchmark (`benchmarks.lm.run_benchmark`, attention "auto")
   at its published widths with 8 and 3 heads (head_dim 96 and 256), its
   first step against the same step with dense attention, K2 launched 12 +
   12 times a step; and the int8-cache `generate` of an f32 2-layer LM
   with 4 heads of 40, token-equal to the CPU. With `--head-dims` this
   phase runs alone;
38. every dtype and width (F12, F13, F14): K2's 3xTF32 instance (float32)
   forward and backward at the LM's (8, 1024, 12, 64), its 8- and 3-head
   (8, 1024, 8, 96) and (8, 1024, 3, 256) causal, ViT-S/16's (256, 197, 6,
   64) full and a ragged (2, 1000, 4, 40) causal bhsd, and K4's at
   ResNet-50's 12 shapes in f32, each against a float64 evaluation (the
   f32 bound, which the plain f32 version is held to as well) and its
   plain version, timed beside SDPA and cuDNN in f32 (TF32 off), and K4's
   at bf16 widths (3, 13) and (100, 36); the LM at its published widths
   in f32 with `flash_attention`, 3 steps against 3 from the same weights
   with dense attention (K2 12 + 12 a step, all on the 3xTF32 instance,
   K1 1 + 1 on f32 logits); ResNet-50 at batch 256 in f32 with
   `fused_1x1_bwd`, 3 steps against the default path (K4 33 a step, all
   on the TF32 instance's 3xTF32 route). With `--f32` this phase runs alone.

Phase 6 asserts that the default path launches K4 no time. Every phase
that counts K1's launches in train steps asserts one launch of its
backward a step beside its forward's (phases 20, 23 and 28 count none).

It prints the card line, one JSON line with every kernel of the paths
(each with its design and its time over the library call's in this run,
`library_ratio`), and last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import http.client
import importlib.metadata
import importlib.util
import io
import json
import math
import os
import pathlib
import shlex
import signal
import socket
import statistics
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
from http.server import ThreadingHTTPServer

import torch
import torch.distributed as dist
import torch.nn.functional as F

import numpy as np
import yaml

from tritonk8ssupervisor_tpu_torch import obs, packaging
from tritonk8ssupervisor_tpu_torch.benchmarks import decode as decode_bench
from tritonk8ssupervisor_tpu_torch.benchmarks import lm as lm_bench
from tritonk8ssupervisor_tpu_torch.benchmarks.resnet50 import run_benchmark
from tritonk8ssupervisor_tpu_torch.cli import main as cli
from tritonk8ssupervisor_tpu_torch.config import compile as compiler
from tritonk8ssupervisor_tpu_torch.config import store as store_lib
from tritonk8ssupervisor_tpu_torch.config.schema import ClusterConfig
from tritonk8ssupervisor_tpu_torch.models import ResNet18, ResNet50, TransformerLM, ViT
from tritonk8ssupervisor_tpu_torch.models import decode as dec
from tritonk8ssupervisor_tpu_torch.models import moe
from tritonk8ssupervisor_tpu_torch.models.resnet import BottleneckBlock, ResNet
from tritonk8ssupervisor_tpu_torch.models.transformer import dense_attention
from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb
from tritonk8ssupervisor_tpu_torch.ops import conv_backward_cuda
from tritonk8ssupervisor_tpu_torch.ops import cross_entropy as ce
from tritonk8ssupervisor_tpu_torch.ops import cuda_build
from tritonk8ssupervisor_tpu_torch.ops import decode_attention as da
from tritonk8ssupervisor_tpu_torch.ops import decode_attention_cuda
from tritonk8ssupervisor_tpu_torch.ops import flash_attention as fa
from tritonk8ssupervisor_tpu_torch.ops import flash_attention_cuda
from tritonk8ssupervisor_tpu_torch.ops.ring_attention import attention_reference, ring_attention
from tritonk8ssupervisor_tpu_torch.parallel import checkpoint as ckpt_lib
from tritonk8ssupervisor_tpu_torch.parallel import distributed, elastic
from tritonk8ssupervisor_tpu_torch.parallel import mesh as mesh_lib
from tritonk8ssupervisor_tpu_torch.parallel import pipeline as pp
from tritonk8ssupervisor_tpu_torch.parallel import spmd, train
from tritonk8ssupervisor_tpu_torch.parallel.ranks import run_ranks
from tritonk8ssupervisor_tpu_torch.provision import autoscale, events, maintenance
from tritonk8ssupervisor_tpu_torch.provision import supervisor as sup_mod
from tritonk8ssupervisor_tpu_torch.provision.runner import CommandError
from tritonk8ssupervisor_tpu_torch.provision.state import ClusterHosts, RunPaths
from tritonk8ssupervisor_tpu_torch.serving import SlotEngine, reqlog, server, traffic
from tritonk8ssupervisor_tpu_torch.serving import fleet as fleet_mod
from tritonk8ssupervisor_tpu_torch.serving import gateway as gateway_mod
from tritonk8ssupervisor_tpu_torch.testing import chaos
from tritonk8ssupervisor_tpu_torch.testing.simclock import SimClock
from tritonk8ssupervisor_tpu_torch.serving.gateway import Request
from tritonk8ssupervisor_tpu_torch.utils import corpus, perf, roofline
from tritonk8ssupervisor_tpu_torch.utils.data import (
    batch_shard,
    global_batch_from_local,
    prefetch_to_mesh,
)

# H100 SXM data sheet, from the port's peak tables: device memory rate,
# f32 rate outside the tensor cores (K1's and K3's bounds); K2's and K4's
# take the rate of f32-accurate products (3xTF32: a third of dense TF32)
# for f32 and the dense bf16/fp16 tensor-core rate otherwise
# (`_peak_flops`). Each kernel's bytes and
# operations come from its module's cost function, which utils/roofline.py
# reads too.
H100 = "NVIDIA H100 80GB HBM3"
HBM_BYTES_PER_S = roofline.PEAK_HBM_BYTES[H100]
F32_FLOPS = roofline.PEAK_F32_FLOPS[H100]
# the kernel against its plain version (same f32 arithmetic, reduced in
# another order; exp and log on the card's fast units)
K1_RTOL = K1_ATOL = 1e-5
# K1's backward against its plain version, as tests/test_torch_kernels.py
# states: in f32 the same arithmetic but for __expf (rtol 1e-5, and 1e-6 of
# the largest |g| where exp(x - lse) - 1 cancels); in bf16 and fp16 at most
# one ulp of the output dtype (significand bits, and the floor: fp16's
# subnormal step, and 2^-126, below which the kernel flushes f32 to zero)
K1_BWD_RTOL = 1e-5
K1_BWD_G_ATOL = 1e-6
K1_BWD_ULP = {torch.bfloat16: (8, 2.0**-126), torch.float16: (11, 2.0**-24)}
# calls a timing of K1's plain versions takes (a yardstick; up to 6.5 ms a
# call at the LM's shape), where the kernels and the library take 200
K1_PLAIN_ITERS = 20
# K2 against its plain version, relative to the reference's largest
# magnitude (at least 1), as tests/test_torch_kernels.py states: the
# kernel keeps scores in f32 and rounds P and dS to bf16 for the next
# product; the plain version in bf16 also rounds the scores (2e-2); on
# f32 copies of the same inputs it rounds nothing (1e-2)
K2_REL_SAME_DTYPE = 2e-2
K2_REL_F32 = 1e-2
# float32 q, k, v on K2's 3xTF32 instance (F12), as tests/test_torch_kernels.py
# states: against a float64 evaluation of the same inputs, relative to the
# f64 result's largest magnitude, O within 2e-5 and dq, dk, dv within 1e-4;
# the plain f32 version on the card within the same, and the kernel within
# twice it of the plain version (both lie within it of f64)
K2_F32_REL = {"out": 2e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4}
# the loss of one bf16 step on the card against the CPU: bf16 activations
# rounded at other points by cuDNN/cuBLAS/K2 and by the CPU kernels
PARITY_LOSS_ATOL = 2e-2
# ViT-S/16's whole first update with K2 against dense attention, as a
# relative norm: the bf16 gradient tolerance of
# tests/test_torch_transformer.py; dense attention rounds its scores to
# bf16 where K2 keeps them in f32
VIT_UPDATE_REL = 5e-2
# K4 against its plain version (the same exact bf16 products summed in f32
# in other orders): dX, rounded to bf16, relative to its largest
# magnitude; dW, f32 throughout, relative to its own
K4_REL_DX = 1e-2
K4_REL_DW = 1e-3
# an f32 compute dtype on K4's TF32 instance ("tf32x3"), as
# tests/test_torch_kernels.py states: elementwise |got - f64| <= 1.01 K
# 2^-24 (|A||B|)_64 + 1e-30 (the forward error bound of an f32 FMA sum in
# any order, K = N for dX and M for dW; 1e-30 covers results flushed to
# zero), for the kernel and the plain f32 version alike, and the kernel
# within twice it of the plain version
K4_F32_REL = 1.01 * 2.0**-24
K4_F32_ATOL = 1e-30
# a fused step's FLOP count against the default path's
FLOPS_RTOL = 1e-3
K1_SOURCE = "cross_entropy.cu"
K2_SOURCE = "flash_attention.cu"
K4_SOURCE = conv_backward_cuda.SOURCE
K3_SOURCE = decode_attention_cuda.SOURCE
K2_TF32_SOURCE = flash_attention_cuda.TF32_SOURCE
K4_TF32_SOURCE = conv_backward_cuda.TF32_SOURCE
# K3 against its plain version, relative to the reference's own largest
# magnitude, as tests/test_torch_kernels.py states: both compute the same
# f32 output up to summation order and __expf (f32: 2e-5) and round it once
# to q's dtype, so a bf16 or fp16 output differs by at most one ulp at the
# largest magnitude (2^-7, 2^-10). Every shape also runs on f32 copies of q,
# which holds its masks and positions to the f32 limit.
K3_REL = {torch.float32: 2e-5, torch.float16: 2**-10, torch.bfloat16: 2**-7}
# decode logits, card against CPU, teacher-forced on the CPU's tokens: f32
# (cuBLAS without TF32 and K3's __expf against the CPU's kernels) 2e-3; bf16
# (activations rounded to bf16 at other points; a logit near 4 steps by
# 2^-5) four steps
DECODE_LOGITS_ATOL = {torch.float32: 2e-3, torch.bfloat16: 1.25e-1}
# the worked example's int8-cache logits with K3 against the same steps
# with its plain version in K3's place, on one card from one set of
# weights, relative to the largest logit: each call may differ by one bf16
# ulp (K3_REL), and the logits are bf16, so four steps at the largest one
WORKED_K3_LOGITS_REL = 2**-5
# ResNet-50's stride-1 1x1 convolutions at batch 256, 224x224 (the
# stage sizes (3, 4, 6, 3) over models/resnet.py's bottleneck blocks):
# (spatial size, C = dX width, N = dY width, calls per step)
K4_SHAPES = [
    (56, 64, 64, 1), (56, 64, 256, 4), (56, 256, 64, 2), (56, 256, 128, 1),
    (28, 128, 512, 4), (28, 512, 128, 3), (28, 512, 256, 1),
    (14, 256, 1024, 6), (14, 1024, 256, 5), (14, 1024, 512, 1),
    (7, 512, 2048, 3), (7, 2048, 512, 2),
]
K4_BATCH = 256


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _build_in_background(source: str):
    """Start one source's nvcc build, so it overlaps the phases before the
    kernel's own."""
    errors: list[BaseException] = []

    def build():
        try:
            cuda_build.load(source)
        except Exception as exc:  # re-raised by the kernel's phase
            errors.append(exc)

    thread = threading.Thread(target=build, daemon=True)
    thread.start()
    return thread, errors


def _join_build(source: str, build, started: float) -> None:
    thread, errors = build
    thread.join()
    if errors:
        raise errors[0]
    print(f"built: {cuda_build.library_path(source).name} "
          f"({time.monotonic() - started:.1f} s into the run)", flush=True)


def _time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time per call on the card: CUDA events around back-to-back
    calls. The inputs stay in L2 between calls where they fit, as the
    producer leaves them for the kernel on the main path."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 10) -> float | None:
    """The card's time per call, without the gaps where it waits for the
    host: the card first spins in a sleep kernel while the host queues
    `iters` calls behind it, and CUDA events time the calls from the end
    of the sleep. It counts only when the host finished queueing before
    the sleep ended (else a 4x longer sleep is tried); None if it never
    did. A call whose Python and autograd overhead exceeds its device
    work then still reads what the card spent."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000  # ~10 ms at the H100's 1.98 GHz
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    return None


def _timings(calls: dict) -> dict:
    """{prefix: (fn, iters)} -> {prefix + "ms": event time, prefix +
    "device_ms": device time}."""
    out = {}
    for prefix, (fn, iters) in calls.items():
        out[f"{prefix}ms"] = _time_ms(fn, iters=iters, warmup=min(20, iters))
        out[f"{prefix}device_ms"] = _device_ms(fn)
    return out


def _kernels_ms(fn, calls: int = 10) -> dict:
    """The card's time per call of each kernel that `fn` launches, by the
    kernel's name, from torch.profiler over `calls` calls; empty when the
    profiler recorded no kernels."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls / 1e3 for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def _max_abs_err(actual: torch.Tensor, expected: torch.Tensor) -> float:
    """max |actual - expected|, with entries where both sides are the same
    infinity counted as equal (inf - inf would read NaN)."""
    actual, expected = actual.float(), expected.float()
    same_inf = torch.isinf(actual) & (actual == expected)
    return torch.where(same_inf, 0.0, (actual - expected).abs()).max().item()


def _bound(cost: tuple[int, int], peak_flops: float) -> tuple[float, str]:
    """(bound ms, what sets it) of a kernel's (bytes, operations)."""
    return roofline.bound_ms(*cost, HBM_BYTES_PER_S, peak_flops)


def _peak_flops(dtype: torch.dtype) -> float:
    """K2's and K4's compute ceiling at `dtype`: the rate of f32-accurate
    products (3xTF32) for f32, the tensor cores' bf16 rate for bf16 and
    fp16."""
    return roofline.kernel_peak_flops(torch.empty((), dtype=dtype).element_size(), H100)


def _library_ratio(r: dict) -> float | None:
    """The kernel's time over the library call's in this run: device times
    where both were read, else event times; None without a library call."""
    if r.get("library_ms") is None:
        return None
    if r.get("device_ms") is not None and r.get("library_device_ms") is not None:
        return r["device_ms"] / r["library_device_ms"]
    return r["ms"] / r["library_ms"]


def _ratio_text(r: dict, library: str) -> str:
    ratio = _library_ratio(r)
    return "" if ratio is None else f", kernel / {library} {ratio:.2f}x"


def _k1_inputs(batch: int, classes: int, seed: int, dtype: torch.dtype):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn(batch, classes, generator=gen, device="cuda") * 4
    labels = torch.randint(0, classes, (batch,), generator=gen,
                           device="cuda", dtype=torch.int32)
    labels[0], labels[1] = -1, classes  # outside [0, C): read incorrect
    for row in range(2, 6):  # two equal maxima, the label on one of them
        top = logits[row].max() + 1.0
        logits[row, 3] = logits[row, classes - 2] = top
        labels[row] = 3 if row % 2 else classes - 2
    return logits.to(dtype), labels


def _k1_gradient_units(got: torch.Tensor, want: torch.Tensor, g: torch.Tensor) -> float:
    """The largest |got - want| of K1's backward in units of the difference
    it may have (K1_BWD_*): at most 1 where it agrees."""
    a, b = got.float(), want.float()
    if got.dtype == torch.float32:
        allowed = K1_BWD_RTOL * b.abs() + K1_BWD_G_ATOL * g.abs().max()
    else:
        bits, floor = K1_BWD_ULP[got.dtype]
        _, exponent = torch.frexp(torch.maximum(a.abs(), b.abs()))
        allowed = torch.ldexp(torch.ones_like(a), exponent - bits).clamp_min(floor)
    return ((a - b).abs() / allowed).max().item()


def check_k1(batch: int, classes: int, seed: int, dtype=torch.float32) -> dict:
    """K1's forward and backward against their plain versions at one shape,
    with the times of each kernel, its plain version and the library's call
    (`F.cross_entropy`, and its backward through autograd on one forward
    built outside the timed call), and their bounds. The backward takes the
    gradient of a mean, a stride-0 g of 1/B, as on the main paths. Returns
    the forward's row with the backward's under "backward"."""
    logits, labels = _k1_inputs(batch, classes, seed, dtype)
    loss, correct, lse = ce.cross_entropy_forward_kernel(logits, labels)
    torch.cuda.synchronize()
    ref_loss, ref_correct, ref_lse = ce.cross_entropy_forward_plain(logits, labels)
    torch.testing.assert_close(loss, ref_loss, rtol=K1_RTOL, atol=K1_ATOL)
    torch.testing.assert_close(lse, ref_lse, rtol=K1_RTOL, atol=K1_ATOL)
    if not torch.equal(correct, ref_correct):
        raise AssertionError(f"K1 correct flags differ at {(batch, classes)}")
    if not correct[2:6].all() or correct[:2].any():
        raise AssertionError("K1: tied labels must read correct, out-of-range incorrect")
    g = torch.full((), 1.0 / batch, device="cuda").expand(batch)
    dlogits = ce.cross_entropy_backward(logits, labels, lse, g)
    torch.cuda.synchronize()
    ref_dlogits = ce.cross_entropy_backward_plain(logits, labels, lse, g)
    units = _k1_gradient_units(dlogits, ref_dlogits, g)
    if not units <= 1.0:
        raise AssertionError(f"K1's backward at {(batch, classes)} {dtype}: {units:.3g} times "
                             "the difference it may have from its plain version")

    in_range = labels.clamp(0, classes - 1).long()  # the library takes only these
    times = _timings({
        "": (lambda: ce.cross_entropy_forward(logits, labels), 200),
        "plain_": (lambda: ce.cross_entropy_forward_plain(logits, labels), K1_PLAIN_ITERS),
        "library_": (lambda: F.cross_entropy(logits, in_range, reduction="none"), 200),
    })
    lib_x = logits.detach().requires_grad_(True)
    lib_loss = F.cross_entropy(lib_x, in_range, reduction="none")
    lib_g = g.to(lib_loss.dtype)
    btimes = _timings({
        "": (lambda: ce.cross_entropy_backward(logits, labels, lse, g), 200),
        "plain_": (lambda: ce.cross_entropy_backward_plain(logits, labels, lse, g),
                   K1_PLAIN_ITERS),
        "library_": (lambda: torch.autograd.grad(lib_loss, lib_x, lib_g, retain_graph=True),
                     200),
    })
    del lib_x, lib_loss
    # each input read once, each output written once (ce.forward_cost,
    # ce.backward_cost)
    elem, label_bytes = logits.element_size(), labels.element_size()
    bound_ms, bound_by = _bound(ce.forward_cost(batch, classes, elem, label_bytes), F32_FLOPS)
    b_bound_ms, b_bound_by = _bound(ce.backward_cost(batch, classes, elem, label_bytes),
                                    F32_FLOPS)
    return {
        "shape": [batch, classes],
        "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": _max_abs_err(loss, ref_loss),
        "max_abs_err_lse": _max_abs_err(lse, ref_lse),
        **times,
        "kernel_ms": times["ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "backward": {
            "shape": [batch, classes],
            "dtype": str(dtype).removeprefix("torch."),
            "g": "stride 0, 1/B (a mean's gradient)",
            "max_abs_err": _max_abs_err(dlogits, ref_dlogits),
            "max_err_in_allowed_units": units,
            **btimes,
            "kernel_ms": btimes["ms"],
            "bound_ms": b_bound_ms,
            "bound_by": b_bound_by,
        },
    }


def _k1_text(row: dict, card: str) -> str:
    """K1's forward and backward at one shape, as printed."""
    b = row["backward"]
    return (f"K1 {row['shape']} {row['dtype']}: forward {_times_text(row, 'F.cross_entropy')}"
            f"{_ratio_text(row, 'F.cross_entropy')}, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), max |err| loss {row['max_abs_err']:.2e} lse "
            f"{row['max_abs_err_lse']:.2e}; backward {_times_text(b, 'F.cross_entropy backward')}"
            f"{_ratio_text(b, 'F.cross_entropy backward')}, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}), max |err| {b['max_abs_err']:.2e} "
            f"({b['max_err_in_allowed_units']:.3f} of the allowed) on {card}")


def _k1_part(row: dict, part: str) -> dict:
    """One direction of a check_k1 row, for the kernels line."""
    if part == "backward":
        return {**row["backward"], "library_ratio": _library_ratio(row["backward"])}
    fwd = {k: v for k, v in row.items() if k != "backward"}
    return {**fwd, "library_ratio": _library_ratio(fwd)}


def check_parity() -> None:
    """Two bf16 ResNet-18 steps through K1 on the card against the same
    steps through K1's plain version on the CPU, from one set of weights;
    the second step's loss reads the first step's update."""
    gen = torch.Generator().manual_seed(2)
    images = torch.randn(16, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (16,), generator=gen, dtype=torch.int32)
    losses = {}
    for device in ("cpu", "cuda"):
        model = ResNet18(num_classes=10, num_filters=8,
                         generator=torch.Generator().manual_seed(0))
        state = train.create_train_state(model, train.default_optimizer(0.1), device)
        step = train.make_train_step(state, metrics_fn=ce.cross_entropy_loss_and_correct)
        before = ce.cross_entropy_forward.launches, ce.cross_entropy_backward.launches
        x, y = images.to(device), labels.to(device)
        losses[device] = [step(x, y)["loss"].item() for _ in range(2)]
        launched = (ce.cross_entropy_forward.launches - before[0],
                    ce.cross_entropy_backward.launches - before[1])
        if launched != ((2, 2) if device == "cuda" else (0, 0)):
            raise AssertionError(f"K1 forward, backward launched {launched} times on {device}")
    diff = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"parity: ResNet-18 bf16 losses over 2 steps, card {losses['cuda']} "
          f"cpu {losses['cpu']}, max |diff| {diff:.2e} (tolerance {PARITY_LOSS_ATOL})",
          flush=True)
    if not diff <= PARITY_LOSS_ATOL:
        raise AssertionError("card and CPU train steps disagree")


def _attention_grads(fn, q, k, v, dout):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v)
    out.backward(dout)
    return [out.detach(), q.grad, k.grad, v.grad]


def _grad_calls(fn, q, k, v, dout):
    """(the backward alone, through one saved forward graph; the forward
    and the backward together), as calls to time."""
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v)
    return (lambda: torch.autograd.grad(out, (q, k, v), dout, retain_graph=True),
            lambda: torch.autograd.grad(fn(q, k, v), (q, k, v), dout))


def _k2_inputs(shape, dtype: torch.dtype, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4)]


def check_k2(b: int, s: int, h: int, d: int, causal: bool, layout: str,
             dtype=torch.bfloat16, seed: int = 0, iters: int = 100, plain_iters: int = 20) -> dict:
    """K2 against its plain version at one shape, forward and backward;
    times `iters` calls of the kernel and of SDPA, `plain_iters` of the
    plain version."""
    shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
    q, k, v, dout = _k2_inputs(shape, dtype, seed)

    def kernel(*x):
        return fa.flash_attention(*x, causal=causal, layout=layout)

    def plain(*x):
        return fa.attention_reference_layout(*x, causal, layout)

    def library(*x):  # SDPA takes (b, h, s, d)
        if layout == "bshd":
            x = [t.transpose(1, 2) for t in x]
        out = F.scaled_dot_product_attention(*x, is_causal=causal)
        return out.transpose(1, 2) if layout == "bshd" else out

    got = _attention_grads(kernel, q, k, v, dout)
    torch.cuda.synchronize()
    same = _attention_grads(plain, q, k, v, dout)
    errors, f64_errors = {}, {}
    if dtype == torch.float32:  # the 3xTF32 instance: the bound against float64
        f64 = _attention_grads(lambda *x: fa.attention_f64(*x, causal, layout),
                               *(x.double() for x in (q, k, v, dout)))
        for name, a, p, e in zip(("out", "dq", "dk", "dv"), got, same, f64):
            bound = K2_F32_REL[name] * e.abs().max().item()
            errors[name] = (a.double() - p.double()).abs().max().item()
            f64_errors[name] = {"kernel": (a.double() - e).abs().max().item(),
                                "plain": (p.double() - e).abs().max().item(), "bound": bound}
            if not (torch.isfinite(a).all() and f64_errors[name]["kernel"] <= bound
                    and f64_errors[name]["plain"] <= bound and errors[name] <= 2 * bound):
                raise AssertionError(f"K2 f32 {name} at {shape} {layout} causal={causal}: "
                                     f"{f64_errors[name]}, kernel - plain {errors[name]:.2e}")
        del f64
    else:
        f32 = _attention_grads(plain, q.float(), k.float(), v.float(), dout.float())
        for name, a, p, e in zip(("out", "dq", "dk", "dv"), got, same, f32):
            if not torch.isfinite(a).all():
                raise AssertionError(f"K2 {name} not finite at {shape}")
            scale_p = p.float().abs().max().clamp(min=1.0).item()
            scale_e = e.float().abs().max().clamp(min=1.0).item()
            errors[name] = _max_abs_err(a, p)
            rel_p, rel_e = errors[name] / scale_p, _max_abs_err(a, e) / scale_e
            if not (rel_p <= K2_REL_SAME_DTYPE and rel_e <= K2_REL_F32):
                raise AssertionError(
                    f"K2 {name} at {shape} {layout} causal={causal}: relative error "
                    f"{rel_p:.2e} vs the plain version, {rel_e:.2e} vs f32"
                )

    out, lse = torch.ops.tk8s.flash_attn_fwd(q, k, v, causal, layout)

    grads = {name: _grad_calls(fn, q, k, v, dout)
             for name, fn in (("", kernel), ("plain_", plain), ("library_", library))}
    times = {
        "forward": _timings({"": (lambda: kernel(q, k, v), iters),
                             "plain_": (lambda: plain(q, k, v), plain_iters),
                             "library_": (lambda: library(q, k, v), iters)}),
        # the kernel's backward alone is its op; plain and SDPA go through
        # autograd on a saved forward graph
        "backward": _timings({"": (lambda: torch.ops.tk8s.flash_attn_bwd(
                                  dout, q, k, v, out, lse, causal, layout), iters),
                              "plain_": (grads["plain_"][0], plain_iters),
                              "library_": (grads["library_"][0], iters)}),
        "fwd_bwd": _timings({name: (calls[1], plain_iters if name == "plain_" else iters)
                             for name, calls in grads.items()}),
    }

    # forward: q, k, v read, O and the f32 logsumexp written; backward:
    # q, k, v, O, dO and the logsumexp read, dq, dk, dv written, and five
    # products (the kernel recomputes P) against the forward's two
    elem = q.element_size()
    fwd_bound, fwd_by = _bound(fa.forward_cost(b, h, s, d, causal, elem), _peak_flops(dtype))
    bwd_bound, bwd_by = _bound(fa.backward_cost(b, h, s, d, causal, elem), _peak_flops(dtype))
    f64_part = ({"forward": {"f64": f64_errors["out"]},
                 "backward": {"f64": {n: f64_errors[n] for n in ("dq", "dk", "dv")}}}
                if f64_errors else {"forward": {}, "backward": {}})
    return {
        "shape": list(shape), "layout": layout, "causal": causal, "seed": seed,
        "dtype": str(dtype).removeprefix("torch."),
        "instance": flash_attention_cuda.instance(dtype, d),
        "forward": {"max_abs_err": errors["out"], **times["forward"],
                    "bound_ms": fwd_bound, "bound_by": fwd_by, **f64_part["forward"]},
        "backward": {"max_abs_err": max(errors["dq"], errors["dk"], errors["dv"]),
                     **times["backward"], "bound_ms": bwd_bound, "bound_by": bwd_by,
                     **f64_part["backward"],
                     "forward_and_backward": {**times["fwd_bwd"],
                                              "bound_ms": fwd_bound + bwd_bound}},
    }


def k2_backward_by_kernel(row: dict) -> dict:
    """The device ms of each kernel of one K2 backward call on `row`'s
    inputs (the rows pre-pass, dK/dV, dQ), from torch.profiler. Taken
    after the LM main path: with these sessions before it, the host-bound
    LM step read 80-90 ms on an H100 that reads it at 51-74 ms without."""
    q, k, v, dout = _k2_inputs(row["shape"], getattr(torch, row["dtype"]), row["seed"])
    out, lse = torch.ops.tk8s.flash_attn_fwd(q, k, v, row["causal"], row["layout"])
    return _kernels_ms(lambda: torch.ops.tk8s.flash_attn_bwd(
        dout, q, k, v, out, lse, row["causal"], row["layout"]))


def _k1_k2_counters() -> tuple:
    """The launch counters of K1's and K2's two directions, in this order."""
    return (ce.cross_entropy_forward, ce.cross_entropy_backward,
            fa.flash_attention_forward, fa.flash_attention_backward)


def check_lm_parity() -> None:
    """Two bf16 LM steps through K1 and K2 on the card against the same
    steps through their plain versions on the CPU, from one set of
    weights; the second step's loss reads the first step's update."""
    tokens = torch.randint(0, 512, (4, 128), generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    counters = _k1_k2_counters()
    losses = {}
    for device in ("cpu", "cuda"):
        model = TransformerLM(vocab_size=512, num_layers=2, num_heads=2, embed_dim=128,
                              max_seq_len=128, attention_fn=fa.flash_attention,
                              generator=torch.Generator().manual_seed(0))
        state = train.create_train_state(model, train.default_optimizer(0.03), device)
        step = train.make_lm_train_step(state, metrics_fn=ce.cross_entropy_loss_and_correct)
        before = [c.launches for c in counters]
        x = tokens.to(device)
        losses[device] = [step(x)["loss"].item() for _ in range(2)]
        launched = [c.launches - n for c, n in zip(counters, before)]
        expected = [2, 2, 4, 4] if device == "cuda" else [0, 0, 0, 0]
        if launched != expected:
            raise AssertionError(f"K1 fwd, K1 bwd, K2 fwd, K2 bwd launched {launched} times on "
                                 f"{device}")
    diff = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"parity: LM bf16 losses over 2 steps, card {losses['cuda']} "
          f"cpu {losses['cpu']}, max |diff| {diff:.2e} (tolerance {PARITY_LOSS_ATOL})",
          flush=True)
    if not diff <= PARITY_LOSS_ATOL:
        raise AssertionError("card and CPU LM train steps disagree")


def run_resnet50(card: str, fused_1x1_bwd: bool = False) -> dict:
    """The ResNet-50 benchmark at batch 256, the default path or the fused
    one; K1's and K4's launches and K4's layout copies counted around it."""
    ce.cross_entropy_forward.launches = ce.cross_entropy_backward.launches = 0
    cb.conv1x1_backward_kernel.launches = 0
    cb.conv1x1_backward.copies = 0
    torch.cuda.reset_peak_memory_stats()
    result = run_benchmark(
        model_name="resnet50", batch_per_chip=256, image_size=224,
        num_classes=1000, steps=10, warmup=2, windows=2, fused_1x1_bwd=fused_1x1_bwd,
    )
    k1, k1_bwd = ce.cross_entropy_forward.launches, ce.cross_entropy_backward.launches
    k4 = cb.conv1x1_backward_kernel.launches
    steps = result["final_step"]
    result["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    result["k4_copies_per_step"] = cb.conv1x1_backward.copies / steps
    name = "resnet50_fused_1x1_bwd" if fused_1x1_bwd else "resnet50"
    print(f"{name}: " + json.dumps(result, sort_keys=True), flush=True)
    if result["platform"] != "gpu" or not math.isfinite(result["final_loss"]):
        raise AssertionError(f"{name} path: platform {result['platform']}, "
                             f"loss {result['final_loss']}")
    k4_per_step = sum(calls for *_, calls in K4_SHAPES) if fused_1x1_bwd else 0
    if (k1, k1_bwd, k4) != (steps, steps, k4_per_step * steps):
        raise AssertionError(f"{name}: K1 launched {k1} + {k1_bwd} and K4 {k4} times in "
                             f"{steps} steps")
    mfu = result["mfu"]
    print(f"main path: {name} batch 256 224x224 bf16, "
          f"{result['images_per_sec']:.1f} img/s, step {result['step_ms']:.2f} ms, "
          f"MFU {'not known' if mfu is None else f'{mfu:.4f}'} "
          f"({result['flops_per_step']:.6g} FLOP/step), peak memory "
          f"{result['peak_memory_bytes'] / 1e9:.2f} GB, launches in {steps} steps: "
          f"K1 {k1} + {k1_bwd} (forward + backward), K4 {k4}, K4 layout copies "
          f"{result['k4_copies_per_step']:g} a step, on {card}", flush=True)
    return {"k1": k1, "k1_backward": k1_bwd, "k4": k4, **result}


def _k4_f32_errors(dx, dw, ref_dx, ref_dw, x2, dy2, w2) -> dict:
    """K4 in f32 against float64: for the kernel and the plain version,
    the largest |got - f64| over K4_F32's bound (at most 1 to pass), and
    the kernel against the plain version over twice it."""
    f64_dx, f64_dw, mag_dx, mag_dw = cb.conv1x1_backward_f64(x2, dy2, w2)
    m, n = dy2.shape
    out = {}
    for name, got, plain, f64, mag, k in (("dx", dx, ref_dx, f64_dx, mag_dx, n),
                                         ("dw", dw, ref_dw, f64_dw, mag_dw, m)):
        bound = K4_F32_REL * k * mag + K4_F32_ATOL
        out[name] = {"kernel": ((got.double() - f64).abs() / bound).max().item(),
                     "plain": ((plain.double() - f64).abs() / bound).max().item(),
                     "kernel_vs_plain": ((got.double() - plain.double()).abs()
                                         / (2 * bound)).max().item()}
    return out


def check_k4(size: int, c: int, n: int, calls: int, seed: int, dtype=torch.bfloat16,
             by_kernel: bool = True) -> dict:
    """K4 against its plain version at one full-width shape (an f32 compute
    dtype also against float64), with the times of the kernel, the plain
    version and cuDNN's backward; with `by_kernel`, its device ms by kernel."""
    m = K4_BATCH * size * size
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x2 = torch.randn(m, c, generator=gen, device="cuda").to(dtype)
    dy2 = torch.randn(m, n, generator=gen, device="cuda").to(dtype)
    w2 = (torch.randn(n, c, generator=gen, device="cuda") / c ** 0.5).to(dtype)
    dx, dw = cb.conv1x1_backward_kernel(x2, dy2, w2)
    torch.cuda.synchronize()
    ref_dx, ref_dw = cb.conv1x1_backward_plain(x2, dy2, w2, dtype)
    err_dx, err_dw = _max_abs_err(dx, ref_dx), _max_abs_err(dw, ref_dw)
    rel_dx = err_dx / ref_dx.float().abs().max().item()
    rel_dw = err_dw / ref_dw.abs().max().item()
    f64 = _k4_f32_errors(dx, dw, ref_dx, ref_dw, x2, dy2, w2) if dtype == torch.float32 else {}
    within = (all(v <= 1.0 for e in f64.values() for v in e.values()) if f64
              else rel_dx <= K4_REL_DX and rel_dw <= K4_REL_DW)
    if not (torch.isfinite(dx).all() and torch.isfinite(dw).all() and within):
        raise AssertionError(f"K4 {dtype} at (M, C, N) = {(m, c, n)}: relative error dX "
                             f"{rel_dx:.2e}, dW {rel_dw:.2e}; against f64 over the bound {f64}")
    del ref_dx, ref_dw, dx, dw

    # the memory one call holds beyond its inputs and outputs (the dW
    # workspace), measured: the allocator's peak during the call less
    # what it still holds after it, with the outputs alive
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = cb.conv1x1_backward_kernel(x2, dy2, w2)
    torch.cuda.synchronize()
    workspace = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
    del out

    # cuDNN on the same memory as (256, C, size, size) channels_last tensors
    x4 = x2.view(K4_BATCH, size, size, c).permute(0, 3, 1, 2)
    dy4 = dy2.view(K4_BATCH, size, size, n).permute(0, 3, 1, 2)
    w4 = w2.view(n, c, 1, 1)

    def library():
        return torch.ops.aten.convolution_backward(
            dy4, x4, w4, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, [True, True, False])

    iters = 50 if m * (c + n) < 2e8 else 20
    times = _timings({
        "": (lambda: cb.conv1x1_backward_kernel(x2, dy2, w2), iters),
        "plain_": (lambda: cb.conv1x1_backward_plain(x2, dy2, w2, dtype), 10),
        "library_": (library, iters),
    })
    # the call's device time by kernel: dgrad, wgrad and the reduction (the
    # TF32 instance's two products are both `gemm_tf32`)
    parts = {}
    for key, ms in (_kernels_ms(lambda: cb.conv1x1_backward_kernel(x2, dy2, w2)).items()
                    if by_kernel else ()):
        part = next((p for p in ("dgrad", "wgrad", "reduce", "gemm") if p in key), "other")
        parts[part] = parts.get(part, 0.0) + ms
    # X, dY and W read once; dX (in their dtype) and dW (f32) written once
    elem = x2.element_size()
    bound_ms, bound_by = _bound(cb.backward_cost(m, c, n, elem), _peak_flops(dtype))
    return {
        "shape": [m, c, n], "calls_per_step": calls, "dtype": str(dtype).removeprefix("torch."),
        "instance": conv_backward_cuda.instance(dtype, c, n),
        "max_abs_err": err_dx, "max_abs_err_dw": err_dw,
        **({"f64_over_bound": f64} if f64 else {}),
        **times, "bound_ms": bound_ms, "bound_by": bound_by,
        "workspace_bytes": workspace, "device_ms_by_kernel": parts,
    }


def check_fused_parity() -> None:
    """Two bf16 steps of a small bottleneck ResNet with both levers on,
    through K1 and K4 on the card against the same steps through their
    plain versions on the CPU, from one set of weights."""
    gen = torch.Generator().manual_seed(4)
    images = torch.randn(16, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (16,), generator=gen, dtype=torch.int32)
    losses = {}
    for device in ("cpu", "cuda"):
        model = ResNet(stage_sizes=(1, 1), block_cls=BottleneckBlock, num_classes=10,
                       num_filters=16, fused_1x1_bwd=True, fast_pool_bwd=True,
                       generator=torch.Generator().manual_seed(0))
        state = train.create_train_state(model, train.default_optimizer(0.1), device)
        step = train.make_train_step(state, metrics_fn=ce.cross_entropy_loss_and_correct)
        counters = (cb.conv1x1_backward_kernel, ce.cross_entropy_backward)
        before = [c.launches for c in counters]
        x, y = images.to(device), labels.to(device)
        losses[device] = [step(x, y)["loss"].item() for _ in range(2)]
        launched = [c.launches - n for c, n in zip(counters, before)]
        # Conv_0 and Conv_2 of both blocks and stage 0's shortcut, 2 steps
        if launched != ([10, 2] if device == "cuda" else [0, 0]):
            raise AssertionError(f"K4, K1 backward launched {launched} times on {device}")
    diff = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"parity: fused bottleneck ResNet bf16 losses over 2 steps, card "
          f"{losses['cuda']} cpu {losses['cpu']}, max |diff| {diff:.2e} "
          f"(tolerance {PARITY_LOSS_ATOL})", flush=True)
    if not diff <= PARITY_LOSS_ATOL:
        raise AssertionError("card and CPU fused train steps disagree")


def run_lm(card: str) -> dict:
    counters = _k1_k2_counters()
    for counter in counters:
        counter.launches = 0
    fa.flash_attention_forward.copies = 0
    torch.cuda.reset_peak_memory_stats()
    result = lm_bench.run_benchmark(steps=10, warmup=2, windows=2)
    k1, k1_bwd, k2_fwd, k2_bwd = (c.launches for c in counters)
    copies = fa.flash_attention_forward.copies
    result["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    print("lm: " + json.dumps(result, sort_keys=True), flush=True)
    steps = result["final_step"]
    if result["platform"] != "gpu" or not math.isfinite(result["final_loss"]):
        raise AssertionError(f"LM path: platform {result['platform']}, "
                             f"loss {result['final_loss']}")
    if result["attention"] != "flash":
        raise AssertionError(f"LM path ran {result['attention']} attention")
    layers = result["num_layers"]
    if (k1, k1_bwd, k2_fwd, k2_bwd) != (steps, steps, layers * steps, layers * steps):
        raise AssertionError(
            f"LM path: {steps} steps launched K1 {k1} + {k1_bwd}, K2 forward {k2_fwd} and "
            f"backward {k2_bwd} times ({layers} layers)"
        )
    if copies:
        raise AssertionError(f"LM path: K2's forward copied {copies} of its q, k, v views")
    mfu = result["mfu"]
    print(f"main path: LM 12L/768/seq 1024/batch 8 bf16, "
          f"{result['tokens_per_sec']:.1f} tokens/s, step {result['step_ms']:.2f} ms, "
          f"MFU {'not known' if mfu is None else f'{mfu:.4f}'} "
          f"({result['flops_per_step']:.4g} FLOP/step, {result['flops_source']}), "
          f"peak memory {result['peak_memory_bytes'] / 1e9:.2f} GB, launches in {steps} "
          f"steps: K1 {k1} + {k1_bwd} (forward + backward), K2 forward {k2_fwd}, K2 backward "
          f"{k2_bwd}, K2 input copies {copies}, on {card}", flush=True)
    return {"k1": k1, "k1_backward": k1_bwd, "k2_forward": k2_fwd, "k2_backward": k2_bwd,
            "k2_copies": copies, "step_ms": result["step_ms"]}


def _k3_rows(pos, b: int, w: int, length: int) -> list[int]:
    """Positions each batch row of a K3 call reads: [0, max pos] of its
    queries, all L when a pos is negative or past the end."""
    if not isinstance(pos, list):
        pos = [[pos] * w] * b
    rows = [p if isinstance(p, list) else [p] for p in pos]
    return [length if min(r) < 0 else min(max(r) + 1, length) for r in rows]


K3_PAGE_SIZE = 16  # the engine benchmark's page size


def _k3_inputs(b: int, w: int, h: int, length: int, d: int, pos, dtype, layout: str,
               seed: int):
    """q, the cache (dense, or for "paged" a pool of b * length / 16 + 1
    pages of 16 positions read through shuffled tables, one page shared by
    two rows, the last table column on the last page), pos (a list made an
    int32 tensor on the card) and the tables (None when dense)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, w, h, d) if w > 1 else (b, h, d), generator=gen, device="cuda").to(dtype)
    tables = None
    if layout == "paged":
        n_pages = length // K3_PAGE_SIZE
        pages = b * n_pages + 1
        cache_shape = (pages, K3_PAGE_SIZE, h, d)
        tables = torch.randperm(pages - 1, generator=gen, device="cuda")[: b * n_pages]
        tables = tables.view(b, n_pages).to(torch.int32)
        if b > 1:
            tables[1, 0] = tables[0, 1]
        tables[:, -1] = pages - 1
    else:
        cache_shape = (b, h, length, d) if layout == "bhld" else (b, length, h, d)
    k8, ks = dec._quant_kv(torch.randn(cache_shape, generator=gen, device="cuda"))
    v8, vs = dec._quant_kv(torch.randn(cache_shape, generator=gen, device="cuda"))
    pos_arg = torch.tensor(pos, dtype=torch.int32, device="cuda") if isinstance(pos, list) else pos
    return q, k8, ks, v8, vs, pos_arg, tables


def check_k3(label: str, b: int, w: int, h: int, length: int, d: int, pos,
             dtype=torch.bfloat16, layout: str = "blhd", seed: int = 0) -> dict:
    """K3 against its plain version at one shape; `pos` an int or a list
    (per row, or per row and query), made an int32 tensor on the card;
    layout "paged" reads a pool through page tables."""
    q, k8, ks, v8, vs, pos_arg, tables = _k3_inputs(b, w, h, length, d, pos, dtype, layout,
                                                    seed)
    args = (q, k8, ks, v8, vs, pos_arg)
    errors = []  # max |err| with q in its dtype, then in f32
    for q_check in (q, q.float()):
        out = da.decode_attention_int8(q_check, *args[1:], layout=layout, tables=tables)
        torch.cuda.synchronize()
        ref = da.decode_attention_int8_plain(q_check, *args[1:], layout=layout, tables=tables)
        errors.append(_max_abs_err(out, ref))
        rel = errors[-1] / ref.float().abs().max().item()
        if not (torch.isfinite(out).all() and rel <= K3_REL[q_check.dtype]):
            raise AssertionError(f"K3 {label}, q {q_check.dtype}: relative error {rel:.2e} "
                                 f"(tolerance {K3_REL[q_check.dtype]:.2e})")
    times = _timings({
        "": (lambda: da.decode_attention_int8(*args, layout=layout, tables=tables), 200),
        "plain_": (lambda: da.decode_attention_int8_plain(*args, layout=layout, tables=tables),
                   20 if length > 4096 else 50),
    })
    positions = sum(_k3_rows(pos, b, w, length))
    # int8 K and V rows and their f32 scales read once for the positions
    # the queries attend (and the page ids of those positions), q read, out
    # written (da.cost)
    page_ids = (0 if tables is None else
                sum(-(-n // K3_PAGE_SIZE) for n in _k3_rows(pos, b, w, length)))
    bound_ms, bound_by = _bound(
        da.cost(h, d, w, positions, q.numel() * q.element_size(), page_ids), F32_FLOPS)
    return {
        "label": label, "shape": [b, w, h, length, d], "layout": layout,
        "dtype": str(dtype).removeprefix("torch."), "pos": pos,
        "max_abs_err": errors[0], "max_abs_err_f32_q": errors[1],
        **times, "kernel_ms": times["ms"],
        "library_ms": None, "library_device_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def launch_floor_ms() -> float | None:
    """The card's time for a one-element in-place fill, timed as the
    kernels are (`_device_ms`): the least a launch costs on this card."""
    x = torch.zeros(1, device="cuda")
    return _device_ms(lambda: x.fill_(1.0), iters=50)


def profile_engine_step(card: str) -> dict:
    """One engine decode step at the engine benchmark's shape (the LM's
    full width, int8 cache, 4 slots of 512, pages of 16; random weights)
    with 4 requests of 256 prompt tokens prefilled: its wall time and the
    card's time by operator from torch.profiler over 5 steps. Returns K3's
    and `aten::index`'s (the page gathers') device ms and calls a step,
    and the step's device total."""
    model = TransformerLM(vocab_size=32768, num_layers=12, num_heads=12, embed_dim=768,
                          max_seq_len=512, generator=torch.Generator().manual_seed(1))
    engine = SlotEngine(model, dec.lm_params(model, "cuda"), slots=4, max_len=512,
                        prefill_chunk=64, page_size=K3_PAGE_SIZE, cache_int8=True,
                        prefix_cache=False)
    rng = np.random.default_rng(0)
    for slot in range(engine.slots):
        tokens = rng.integers(0, 32768, 256).astype(np.int32)
        engine.join(slot, Request(rid=slot, prompt_len=256, max_new_tokens=64, tokens=tokens))
    while not engine.active.all():
        engine.step()

    def step():
        return engine._decode(engine.model, engine.params, engine.pool, engine.last,
                              engine.pos, engine.active.copy())

    step()
    torch.cuda.synchronize()
    start = time.monotonic()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - start) / 20 * 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
    by_op = {e.key: (e.self_device_time_total / 5e3, e.count // 5) for e in ops}
    device_ms = sum(ms for ms, _ in by_op.values()) if ops else None
    k3_ms, k3_calls = by_op.get("tk8s::decode_attn_int8", (0.0, 0))
    gather_ms, gather_calls = by_op.get("aten::index", (0.0, 0))
    result = {"wall_ms": wall_ms, "device_ms": device_ms, "k3_device_ms": k3_ms,
              "k3_calls": k3_calls, "gather_device_ms": gather_ms, "gather_calls": gather_calls,
              "pos": int(engine.pos.max())}
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:8]
    print("engine step: " + json.dumps(result, sort_keys=True), flush=True)
    print(f"engine decode step, 4 slots at pos {result['pos']}, int8 cache: wall {wall_ms:.3f} ms, "
          f"card busy {'not measured' if device_ms is None else f'{device_ms:.4f} ms'}; K3 "
          f"{k3_calls} calls {k3_ms:.4f} device ms, page gathers (aten::index) {gather_calls} "
          f"calls {gather_ms:.4f} device ms a step; by operator: " + ", ".join(
              f"{e.key} {e.self_device_time_total / 5e3:.4f} ms ({e.count // 5})" for e in top)
          + f" on {card}", flush=True)
    if device_ms is not None and k3_calls != model.num_layers:
        raise AssertionError(f"engine step: K3 ran {k3_calls} times, not once a layer")
    return result


def _decode_logits(model, params, prompt, tokens) -> torch.Tensor:
    """The logits of every step of `generate` with the int8 cache, fed
    `tokens` (B, N) in turn: (B, N, vocab) f32 on the host."""
    s = prompt.shape[1]
    cache, logits = dec.prefill(model, params, prompt, model.max_seq_len, cache_int8=True)
    steps = [logits]
    for t in range(tokens.shape[1] - 1):
        steps.append(dec.decode_step(model, params, cache, tokens[:, t:t + 1], s + t))
    return torch.stack(steps, 1).float().cpu()


def check_decode_parity(num_heads: int = 2, embed_dim: int = 128,
                        dtypes=(torch.float32, torch.bfloat16)) -> int:
    """Greedy int8-cache `generate` of 2-layer LMs in each of `dtypes` on
    the card (K3) against the CPU (its plain version), from one set of
    weights; f32 tokens must be equal. Returns K3's launches on the card."""
    prompt = torch.randint(0, 512, (4, 16), generator=torch.Generator().manual_seed(6))
    k3 = 0
    for dtype in dtypes:
        model = TransformerLM(vocab_size=512, num_layers=2, num_heads=num_heads,
                              embed_dim=embed_dim, max_seq_len=64, dtype=dtype,
                              logits_dtype=dtype, generator=torch.Generator().manual_seed(0))
        tokens, logits = {}, {}
        for device in ("cpu", "cuda"):
            params = dec.lm_params(model, device)
            before = da.decode_attention_kernel.launches
            tokens[device] = dec.generate(model, params, prompt.to(device), 24,
                                          cache_int8=True).cpu()
            launched = da.decode_attention_kernel.launches - before
            if launched != (2 * 23 if device == "cuda" else 0):
                raise AssertionError(f"K3 launched {launched} times on {device}")
            k3 += launched
            logits[device] = _decode_logits(model, params, prompt.to(device),
                                            tokens["cpu"].to(device))
        diff = (logits["cuda"] - logits["cpu"]).abs().max().item()
        top2 = logits["cpu"].topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]).min().item()
        flips = int((tokens["cuda"] != tokens["cpu"]).sum())
        name = str(dtype).removeprefix("torch.")
        print(f"parity: decode {name} int8 cache, {num_heads} heads of {embed_dim // num_heads}, "
              f"4 x 24 tokens: {flips} tokens differ, max "
              f"|logit diff| {diff:.2e} (tolerance {DECODE_LOGITS_ATOL[dtype]}), min top-2 "
              f"margin {margin:.3e}", flush=True)
        if not diff <= DECODE_LOGITS_ATOL[dtype]:
            raise AssertionError(f"card and CPU decode logits disagree ({name})")
        if dtype == torch.float32 and flips:
            raise AssertionError("card and CPU f32 decode tokens differ")
    return k3


def check_engine_parity() -> None:
    """A small f32 `SlotEngine` with a drafter and the int8 cache (decode,
    drafter and verify attention through K3) on the card against the CPU,
    from one set of weights: the same tokens."""
    model = TransformerLM(vocab_size=512, num_layers=2, num_heads=2, embed_dim=128,
                          max_seq_len=64, dtype=torch.float32, logits_dtype=torch.float32,
                          generator=torch.Generator().manual_seed(0))
    draft = TransformerLM(vocab_size=512, num_layers=1, num_heads=2, embed_dim=32,
                          max_seq_len=64, dtype=torch.float32, logits_dtype=torch.float32,
                          generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (10, 20, 14)]
    outs = {}
    for device in ("cpu", "cuda"):
        engine = SlotEngine(model, dec.lm_params(model, device), slots=2, max_len=64,
                            prefill_chunk=8, page_size=8, cache_int8=True, draft_model=draft,
                            draft_params=dec.lm_params(draft, device), spec_k=3)
        before = da.decode_attention_kernel.launches
        outs[device] = decode_bench.drive(engine, prompts, 12)
        launched = da.decode_attention_kernel.launches - before
        if len(outs[device]) != len(prompts):
            raise AssertionError(f"the engine on {device} answered {len(outs[device])} of "
                                 f"{len(prompts)} requests")
        if (launched > 0) != (device == "cuda"):
            raise AssertionError(f"K3 launched {launched} times on {device}")
    print(f"parity: f32 SlotEngine with a drafter, int8 cache, 3 requests x 12 tokens: "
          f"card {'equals' if outs['cuda'] == outs['cpu'] else 'differs from'} CPU", flush=True)
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError(f"engine tokens differ: card {outs['cuda']} cpu {outs['cpu']}")


def profile_decode(card: str) -> dict | None:
    """One decode forward of the decode benchmark's model (batch 8, a
    640-long cache, pos 383: the mean position of a call at the
    benchmark's defaults, 512 new tokens) with each cache:
    its wall time, and the card's busy time by operator from
    torch.profiler over 5 steps. (A step is ~700 launches, more than the
    launch queue holds behind `_device_ms`'s sleep, so the card's time is
    the profiler's sum of kernel times.) Returns K3's row of the int8
    step, {"device_ms": a step, "calls": a step, "pos": 383}, or None
    when the profiler recorded no K3 kernel."""
    k3 = None
    model = TransformerLM(vocab_size=32768, num_layers=12, num_heads=12, embed_dim=768,
                          max_seq_len=640, generator=torch.Generator().manual_seed(1))
    params = dec.lm_params(model, "cuda")
    prompt = torch.randint(0, 32768, (8, 128), generator=torch.Generator().manual_seed(0)).cuda()
    for cache_int8 in (False, True):
        cache, _ = dec.prefill(model, params, prompt, 640, cache_int8=cache_int8)

        def step():
            return dec.decode_step(model, params, cache, prompt[:, :1], 383)

        step()
        torch.cuda.synchronize()
        start = time.monotonic()
        for _ in range(20):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - start) / 20 * 1e3
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step()
            torch.cuda.synchronize()
        ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in ops) / 5e3
        top = sorted(ops, key=lambda e: -e.self_device_time_total)[:8]
        busy = ("not measured (the profiler recorded no kernels)" if not ops else
                f"{busy_ms:.4f} ms, the card idle {1 - busy_ms / wall_ms:.1%}")
        k3 = next(({"device_ms": e.self_device_time_total / 5e3, "calls": e.count // 5,
                    "pos": 383} for e in ops if e.key == "tk8s::decode_attn_int8"), k3)
        print(f"decode step {'int8' if cache_int8 else 'bf16'} cache, batch 8, pos 383: wall "
              f"{wall_ms:.3f} ms, card busy {busy}; by operator (calls a step): " + ", ".join(
                  f"{e.key} {e.self_device_time_total / 5e3:.4f} ms ({e.count // 5})" for e in top)
              + f" on {card}", flush=True)
    return k3


# the decode benchmark's runs in phases 13 and 26: its defaults with 64 new
# tokens and one timed call after the first (cut from 512 and 3, and the
# two-process runs' from 128, to keep the whole script inside its time limit)
DECODE_DEPTH = dict(new_tokens=64, repeats=1)


def run_decode(card: str, k3_step: dict | None) -> tuple[dict, dict]:
    """The decode benchmark at DECODE_DEPTH three ways, with K3's launches
    counted around each; returns them and the int8-cache run's result
    (its tokens kept for phase 26)."""
    launches = {}
    for name, options in (("decode_bf16_cache", {}), ("decode_cache_int8", {"cache_int8": True}),
                          ("decode_int8_weights_cache_int8", {"int8": True, "cache_int8": True})):
        da.decode_attention_kernel.launches = 0
        result = decode_bench.run_benchmark(keep_tokens=True, **DECODE_DEPTH, **options)
        launches[name] = da.decode_attention_kernel.launches
        tokens = result.pop("tokens")
        if name == "decode_cache_int8":
            single = {**result, "tokens": tokens}
        print(f"{name}: " + json.dumps(result, sort_keys=True), flush=True)
        if result["platform"] != "gpu":
            raise AssertionError(f"{name} ran on {result['platform']}")
        calls = 1 + DECODE_DEPTH["repeats"]  # the first call and the timed repeats
        expected = result["num_layers"] * (result["new_tokens"] - 1) * calls
        if launches[name] != (expected if result["cache_int8"] else 0):
            raise AssertionError(f"{name}: K3 launched {launches[name]} times "
                                 f"({expected} expected with the int8 cache)")
        k3_text = ("" if not result["cache_int8"] else
                   ", K3 device time not measured (the profiler recorded no K3 kernel)"
                   if k3_step is None else
                   f", K3 {k3_step['calls']} x {k3_step['device_ms'] / k3_step['calls']:.4f} = "
                   f"{k3_step['device_ms']:.4f} device ms in a step at pos {k3_step['pos']} "
                   f"({k3_step['device_ms'] / result['ms_per_token_per_stream']:.1%} of a "
                   f"step's wall time; torch.profiler)")
        print(f"main path: {name} 12L/768/vocab 32768 bf16, batch 8, prompt 128, "
              f"{result['new_tokens']} new: "
              f"{result['tokens_per_sec']:.1f} tokens/s, "
              f"{result['ms_per_token_per_stream']:.3f} ms a step (ms/token/stream){k3_text}, "
              f"peak memory {result['peak_memory_gb']:.2f} GB, K3 launches "
              f"{launches[name]}, on {card}", flush=True)
    return launches, single


def run_engine(card: str) -> int:
    """The engine benchmark at the LM's full width with the int8 cache, with
    K3's launches counted around it; returns them."""
    da.decode_attention_kernel.launches = 0
    result = decode_bench.run_engine_benchmark(vocab_size=32768, num_layers=12, num_heads=12,
                                               embed_dim=768, cache_int8=True)
    launched = da.decode_attention_kernel.launches
    print("engine: " + json.dumps(result, sort_keys=True), flush=True)
    spec = result["speculative"]
    hits = result["warm"]["prefix"]["hits"]
    if not (result["platform"] == "gpu" and result["token_identical"]
            and spec["token_identical"] and hits >= result["requests"]
            and result["shared_prefix_reprefilled_on_hits"] == 0 and launched > 0):
        raise AssertionError(
            f"engine path: token_identical {result['token_identical']}, spec token_identical "
            f"{spec['token_identical']}, hits {hits}, re-prefilled "
            f"{result['shared_prefix_reprefilled_on_hits']}, K3 launches {launched}")
    print(f"main path: engine 12L/768/vocab 32768 int8 cache, {result['requests']} requests, "
          f"{result['slots']} slots: warm/cold {result['value']}x "
          f"({result['warm']['tokens_per_sec']:.1f} vs {result['cold']['tokens_per_sec']:.1f} "
          f"tokens/s), spec/spec_base {spec['value']}x "
          f"({spec['spec']['tokens_per_sec']:.1f} vs {spec['baseline']['tokens_per_sec']:.1f}), "
          f"acceptance {spec['acceptance_rate']}, cold = warm and spec = spec_base token for "
          f"token, peak memory {result['peak_memory_gb']:.2f} GB, K3 launches {launched}, "
          f"on {card}", flush=True)
    return launched


# Phases of the ViT, the mixture-of-experts LM and checkpointing
MOE_PARITY_CAPACITY_FACTOR = 0.5  # low enough that choices drop
VIT_STEPS = dict(steps=10, warmup=2, windows=2)
MOE_LM_STEPS = dict(steps=10, warmup=2, windows=2)


def _count_drops(model) -> list[int]:
    """Hooks on every MoE block of `model` that append, on each forward,
    the number of top-k choices its capacity dropped (the dispatch
    recomputed from the block's input); returns the list they fill."""
    drops: list[int] = []

    def hook(layer, inputs, _output):
        with torch.no_grad():
            x = inputs[0]
            probs = torch.softmax(x.float() @ layer.router_kernel, dim=-1)
            capacity = moe.compute_capacity(x.shape[1], layer.num_experts, layer.k,
                                            layer.capacity_factor)
            dispatch = moe.top_k_dispatch(probs, layer.k, capacity)[0]
            drops.append(int(x.shape[0] * x.shape[1] * layer.k - dispatch.sum().item()))

    for module in model.modules():
        if isinstance(module, moe.MoEMLP):
            module.register_forward_hook(hook)
    return drops


def _paired_losses(label: str, make_model, batch_on, step_factory, expected: list[int]) -> None:
    """Two bf16 steps of `make_model()` on the card (through K1 and K2)
    and on the CPU (their plain versions), from one set of weights;
    `expected` is K1's and K2's forward's and backward's launches on the
    card. Prints the losses and the choices the MoE blocks dropped."""
    counters = _k1_k2_counters()
    losses, drops = {}, {}
    for device in ("cpu", "cuda"):
        model = make_model()
        drops[device] = _count_drops(model)
        state = train.create_train_state(model, train.default_optimizer(0.03), device)
        step = step_factory(state, metrics_fn=ce.cross_entropy_loss_and_correct)
        before = [c.launches for c in counters]
        batch = batch_on(device)
        losses[device] = [step(*batch)["loss"].item() for _ in range(2)]
        launched = [c.launches - n for c, n in zip(counters, before)]
        if launched != (expected if device == "cuda" else [0, 0, 0, 0]):
            raise AssertionError(f"{label}: K1 fwd, K1 bwd, K2 fwd, K2 bwd launched {launched} "
                                 f"times on {device}")
    diff = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    dropped = (f", top-k choices dropped by capacity a forward: card {drops['cuda']} cpu "
               f"{drops['cpu']}" if drops["cuda"] else "")
    print(f"parity: {label} bf16 losses over 2 steps, card {losses['cuda']} cpu "
          f"{losses['cpu']}, max |diff| {diff:.2e} (tolerance {PARITY_LOSS_ATOL}){dropped}",
          flush=True)
    if not diff <= PARITY_LOSS_ATOL:
        raise AssertionError(f"card and CPU {label} train steps disagree")
    if drops["cuda"] and not min(drops["cuda"]) > 0:
        raise AssertionError(f"{label}: the capacity dropped no choice")


def check_moe_lm_parity() -> None:
    """Two bf16 steps of a 2-layer LM (2 heads of 64, seq 128, vocab 512)
    whose second block is a mixture of 4 experts (k = 2) at a capacity
    factor that drops choices."""
    tokens = torch.randint(0, 512, (4, 128), generator=torch.Generator().manual_seed(5),
                           dtype=torch.int32)
    _paired_losses(
        "MoE LM",
        lambda: TransformerLM(vocab_size=512, num_layers=2, num_heads=2, embed_dim=128,
                              max_seq_len=128, attention_fn=fa.flash_attention, moe_experts=4,
                              moe_capacity_factor=MOE_PARITY_CAPACITY_FACTOR,
                              generator=torch.Generator().manual_seed(0)),
        lambda device: (tokens.to(device),), train.make_lm_train_step, [2, 2, 4, 4])


def check_vit_parity() -> None:
    """Two bf16 steps of a 2-layer ViT (2 heads of 64, 32x32 images,
    patch 8, 10 classes), with dense attention and with `flash_attention`."""
    gen = torch.Generator().manual_seed(6)
    images = torch.randn(16, 32, 32, 3, generator=gen)
    labels = torch.randint(0, 10, (16,), generator=gen, dtype=torch.int32)
    for name, attention, k2 in (("dense", dense_attention, 0), ("flash", fa.flash_attention, 4)):
        _paired_losses(
            f"ViT ({name} attention)",
            lambda attention=attention: ViT(
                num_classes=10, patch_size=8, num_layers=2, num_heads=2, embed_dim=128,
                image_size=32, attention_fn=attention, generator=torch.Generator().manual_seed(0)),
            lambda device: (images.to(device), labels.to(device)), train.make_train_step,
            [2, 2, k2, k2])


def _counted(run):
    """run() with K1's, K2's and K4's launch counters and K2's copies set
    to 0 just before it: (its result, {counter: count just after})."""
    ce.cross_entropy_forward.launches = ce.cross_entropy_backward.launches = 0
    fa.flash_attention_forward.launches = fa.flash_attention_backward.launches = 0
    fa.flash_attention_forward.copies = 0
    cb.conv1x1_backward_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    result = run()
    return result, {"k1": ce.cross_entropy_forward.launches,
                    "k1_backward": ce.cross_entropy_backward.launches,
                    "k2_forward": fa.flash_attention_forward.launches,
                    "k2_backward": fa.flash_attention_backward.launches,
                    "k2_copies": fa.flash_attention_forward.copies,
                    "k4": cb.conv1x1_backward_kernel.launches,
                    "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def _vit_s16(attention_fn) -> ViT:
    return ViT(num_classes=1000, image_size=224, attention_fn=attention_fn)


def _vit_batch():
    """The image benchmark's synthetic batch at ViT-S/16's configuration."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn((256, 224, 224, 3), generator=gen, device="cuda", dtype=torch.bfloat16)
    labels = torch.randint(0, 1000, (256,), generator=gen, device="cuda", dtype=torch.int32)
    return images, labels


def run_vit(card: str) -> dict:
    """The ViT main path: the image benchmark with model_name="vit" at
    ViT-S/16's configuration (batch 256, 224x224, 1000 classes; the
    reference's default dense attention), then the same step with
    `flash_attention` (K2), timed by the same windows; from the same
    weights and batch, the first update and the second step's loss of
    both."""
    result, counts = _counted(lambda: run_benchmark(
        model_name="vit", batch_per_chip=256, image_size=224, num_classes=1000, **VIT_STEPS))
    steps = result["final_step"]
    result["peak_memory_bytes"] = counts["peak_memory_bytes"]
    print("vit: " + json.dumps(result, sort_keys=True), flush=True)
    if result["platform"] != "gpu" or not math.isfinite(result["final_loss"]):
        raise AssertionError(f"ViT path: platform {result['platform']}, "
                             f"loss {result['final_loss']}")
    if (counts["k1"], counts["k1_backward"], counts["k2_forward"],
            counts["k2_backward"]) != (steps, steps, 0, 0):
        raise AssertionError(f"ViT path: {steps} steps launched {counts}")
    mfu = result["mfu"]
    print(f"main path: ViT-S/16 batch 256 224x224 bf16, dense attention, "
          f"{result['images_per_sec']:.1f} img/s, step {result['step_ms']:.2f} ms "
          f"(windows {result['step_ms_windows']}), MFU "
          f"{'not known' if mfu is None else f'{mfu:.4f}'} ({result['flops_per_step']:.6g} "
          f"FLOP/step, {result['flops_source']}), peak memory "
          f"{counts['peak_memory_bytes'] / 1e9:.2f} GB, launches in {steps} steps: K1 "
          f"{counts['k1']} + {counts['k1_backward']} (forward + backward), K2 0, on {card}",
          flush=True)

    images, labels = _vit_batch()
    deltas, second = {}, {}
    for name, attention in (("dense", dense_attention), ("flash", fa.flash_attention)):
        state = train.create_train_state(_vit_s16(attention), train.default_optimizer(0.1))
        step = train.make_train_step(state)
        before = torch.cat([p.detach().flatten() for p in state.model.parameters()])
        step(images, labels)
        deltas[name] = torch.cat([p.detach().flatten() for p in state.model.parameters()]) - before
        second[name] = step(images, labels)["loss"].item()
        del state, step, before
    # the first update is -lr (1 + momentum) times the gradient, which runs
    # through K2's forward and backward in all 12 blocks
    rel = ((deltas["flash"] - deltas["dense"]).norm() / deltas["dense"].norm()).item()
    diff = abs(second["flash"] - second["dense"])
    print(f"ViT-S/16 from one set of weights and batch, flash against dense attention: "
          f"first update |d_flash - d_dense| / |d_dense| {rel:.2e} (tolerance {VIT_UPDATE_REL}), "
          f"second-step loss flash {second['flash']:.6f} dense {second['dense']:.6f}, "
          f"|diff| {diff:.2e} (tolerance {PARITY_LOSS_ATOL})", flush=True)
    del deltas
    if not (rel <= VIT_UPDATE_REL and diff <= PARITY_LOSS_ATOL):
        raise AssertionError("ViT-S/16: flash and dense attention disagree")

    def flash_run():
        state = train.create_train_state(_vit_s16(fa.flash_attention),
                                         train.default_optimizer(0.1))
        step = train.make_train_step(state)
        timing = perf.timed_windows(lambda: step(images, labels), **VIT_STEPS)
        return {**timing, "steps_run": state.step}

    flash, fcounts = _counted(flash_run)
    fsteps = flash["steps_run"]
    print(f"ViT-S/16 with flash_attention (K2, non-causal, 197 tokens): step "
          f"{flash['step_ms']:.2f} ms (windows {flash['step_ms_windows']}) against dense "
          f"{result['step_ms']:.2f} ms, peak memory {fcounts['peak_memory_bytes'] / 1e9:.2f} GB, "
          f"launches in {fsteps} steps: K1 {fcounts['k1']} + {fcounts['k1_backward']}, K2 forward "
          f"{fcounts['k2_forward']}, backward {fcounts['k2_backward']}, K2 input copies "
          f"{fcounts['k2_copies']}, on {card}", flush=True)
    layers = 12
    if (fcounts["k1"], fcounts["k1_backward"], fcounts["k2_forward"], fcounts["k2_backward"],
            fcounts["k2_copies"]) != (fsteps, fsteps, layers * fsteps, layers * fsteps, 0):
        raise AssertionError(f"ViT flash path: {fsteps} steps launched {fcounts}")
    return {"k1": counts["k1"], "k1_backward": counts["k1_backward"], "k2_forward": 0,
            "flash_k1": fcounts["k1"], "flash_k1_backward": fcounts["k1_backward"],
            "flash_k2_forward": fcounts["k2_forward"],
            "flash_k2_backward": fcounts["k2_backward"], "flash_k2_copies": fcounts["k2_copies"],
            "step_ms": result["step_ms"], "flash_step_ms": flash["step_ms"],
            "flops_per_step": result["flops_per_step"]}


def run_moe_lm(card: str) -> dict:
    """The MoE LM main path: the LM benchmark at its published widths with
    every second block a mixture of 8 experts (k = 2, capacity factor
    1.25)."""
    result, counts = _counted(lambda: lm_bench.run_benchmark(
        moe_experts=8, moe_every=2, **MOE_LM_STEPS))
    steps, layers = result["final_step"], result["num_layers"]
    result["peak_memory_bytes"] = counts["peak_memory_bytes"]
    print("moe_lm: " + json.dumps(result, sort_keys=True), flush=True)
    if result["platform"] != "gpu" or not math.isfinite(result["final_loss"]):
        raise AssertionError(f"MoE LM path: platform {result['platform']}, "
                             f"loss {result['final_loss']}")
    if not (math.isfinite(result["router_loss"]) and result["router_loss"] > 0):
        raise AssertionError(f"MoE LM path: router loss {result['router_loss']}")
    if (counts["k1"], counts["k1_backward"], counts["k2_forward"], counts["k2_backward"],
            counts["k2_copies"]) != (steps, steps, layers * steps, layers * steps, 0):
        raise AssertionError(f"MoE LM path: {steps} steps launched {counts}")
    mfu = result["mfu"]
    print(f"main path: MoE LM 12L/768/seq 1024/batch 8 bf16, 6 blocks of 8 experts (k 2, "
          f"capacity factor 1.25), {result['tokens_per_sec']:.1f} tokens/s, step "
          f"{result['step_ms']:.2f} ms (windows {result['step_ms_windows']}), MFU "
          f"{'not known' if mfu is None else f'{mfu:.4f}'} ({result['flops_per_step']:.4g} "
          f"FLOP/step, {result['flops_source']}; the MoE blocks' dispatch and combine products "
          f"with the one-hots and the expert products at capacity, 320 slots an expert a row, "
          f"are counted), router loss of the last step {result['router_loss']:.6f}, peak memory "
          f"{counts['peak_memory_bytes'] / 1e9:.2f} GB, launches in {steps} steps: K1 "
          f"{counts['k1']} + {counts['k1_backward']}, K2 forward {counts['k2_forward']}, "
          f"backward {counts['k2_backward']}, K2 input copies {counts['k2_copies']}, on {card}",
          flush=True)
    return {**counts, "step_ms": result["step_ms"]}


CKPT_LM = ["--vocab-size", "512", "--num-layers", "2", "--num-heads", "2", "--embed-dim",
           "128", "--seq-len", "128", "--batch-per-data-shard", "4", "--moe-experts", "4"]


def _lm_kwargs(args: list[str]) -> dict:
    parsed = lm_bench.build_parser().parse_args(args)
    return {k: getattr(parsed, k) for k in (
        "vocab_size", "num_layers", "num_heads", "embed_dim", "seq_len",
        "batch_per_data_shard", "moe_experts", "steps", "warmup", "windows", "checkpoint_dir")}


def _restored(directory: str, step: int | None = None) -> train.TrainState:
    kw = _lm_kwargs(CKPT_LM)
    model = TransformerLM(vocab_size=kw["vocab_size"], num_layers=kw["num_layers"],
                          num_heads=kw["num_heads"], embed_dim=kw["embed_dim"],
                          max_seq_len=kw["seq_len"], moe_experts=kw["moe_experts"],
                          generator=torch.Generator().manual_seed(7))
    state = train.create_train_state(model, train.default_optimizer())
    return ckpt_lib.TrainCheckpointer(directory).restore(state, step)


def check_checkpoint_resume(card: str) -> dict:
    """A small MoE LM through the LM benchmark (K1, K2): 6 steps straight,
    against 3 steps with `checkpoint_dir` and 3 more in a fresh process
    that restores them. The two step-6 checkpoints must be bit-equal
    (tolerance 0: K2's backward has no atomics and every product runs at
    the same shapes). Then the resumed run's step 6 is torn: a restore
    must fall back to step 3."""
    with tempfile.TemporaryDirectory() as root:
        straight, halves = f"{root}/straight", f"{root}/halves"
        lm_bench.run_benchmark(**_lm_kwargs(
            CKPT_LM + ["--steps", "2", "--warmup", "1", "--windows", "2",
                       "--checkpoint-dir", straight]))
        first = lm_bench.run_benchmark(**_lm_kwargs(
            CKPT_LM + ["--steps", "1", "--warmup", "1", "--windows", "1",
                       "--checkpoint-dir", halves]))
        out = subprocess.run(
            [sys.executable, "-m", "tritonk8ssupervisor_tpu_torch.benchmarks.lm", *CKPT_LM,
             "--steps", "1", "--warmup", "1", "--windows", "1", "--checkpoint-dir", halves,
             "--json"], capture_output=True, text=True, timeout=300,
            cwd=pathlib.Path(__file__).resolve().parent)
        if out.returncode:
            raise AssertionError(f"the resumed run failed: {out.stderr[-2000:]}")
        second = json.loads(out.stdout.strip().splitlines()[-1])
        if (first["final_step"], second["start_step"], second["final_step"]) != (3, 3, 6):
            raise AssertionError(f"resume: first run ended at {first['final_step']}, the "
                                 f"second ran {second['start_step']} -> {second['final_step']}")
        a, b = _restored(straight), _restored(halves)
        diffs = [(x.float() - y.float()).abs().max().item()
                 for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values())]
        diffs += [(a.optimizer.state[p]["momentum_buffer"]
                   - b.optimizer.state[q]["momentum_buffer"]).abs().max().item()
                  for p, q in zip(a.model.parameters(), b.model.parameters())]
        steps = (a.step, b.step)
        for f in pathlib.Path(halves, "6").rglob("*"):  # torn, its marker intact
            if f.is_file():
                f.write_bytes(b"x")
        fallback = _restored(halves).step
    result = {"steps": steps, "max_abs_diff": max(diffs), "fallback_step": fallback,
              "restore_seconds": second["restore_seconds"]}
    print(f"checkpoint: 6 LM steps straight against 3 + save + a fresh process that restores "
          f"and runs 3: steps {steps}, max |diff| over parameters and momentum "
          f"{result['max_abs_diff']:.3g} (tolerance 0), restore_seconds "
          f"{result['restore_seconds']:.4f}; the resumed run's step 6 torn: restore fell back "
          f"to step {fallback}, on {card}", flush=True)
    if steps != (6, 6) or result["max_abs_diff"] != 0.0 or fallback != 3:
        raise AssertionError(f"checkpoint resume: {result}")
    return result


def _profile_step(step, steps: int = 2):
    """step() run `steps` times under torch.profiler after one warm call:
    (wall ms a step, the card's busy ms a step, the operator rows grouped
    by input shape)."""
    step()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities, record_shapes=True) as prof:
        start = time.monotonic()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - start) / steps * 1e3
    rows = prof.key_averages(group_by_input_shape=True)
    busy = sum(e.self_device_time_total for e in perf.card_work(rows)) / steps / 1e3
    ops = [e for e in rows if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    return wall_ms, busy, ops


def _by_operator(ops, steps: int = 2) -> dict:
    out: dict[str, float] = {}
    for e in ops:
        out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total / steps / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profile_breakdowns(card: str) -> dict:
    """Where a ViT-S/16 step (dense attention, the benchmark's path) and a
    MoE LM step go on the card, from torch.profiler over 2 steps; for the
    MoE LM, the einsum products (aten::bmm: the only bmm calls of that
    step) split by shape into the expert products (a dimension of the
    3072-wide FFN) and the dispatch and combine products (the rest; their
    forward and backward products have the same shapes, so they are
    summed together). Run last: a profiler session slows later host-bound
    paths."""
    out = {}
    images, labels = _vit_batch()
    state = train.create_train_state(_vit_s16(dense_attention), train.default_optimizer(0.1))
    step = train.make_train_step(state)
    wall, busy, ops = _profile_step(lambda: step(images, labels))
    out["vit"] = {"wall_ms": wall, "device_ms": busy,
                  "by_operator": dict(list(_by_operator(ops).items())[:10])}
    del state, step

    model = TransformerLM(vocab_size=32768, num_layers=12, num_heads=12, embed_dim=768,
                          max_seq_len=1024, attention_fn=fa.flash_attention, moe_experts=8)
    state = train.create_train_state(model, train.default_optimizer(0.03))
    lm_step = train.make_lm_train_step(state)
    tokens = _lm_tokens()
    wall, busy, ops = _profile_step(lambda: lm_step(tokens))
    expert = sum(e.self_device_time_total for e in ops if e.key == "aten::bmm"
                 and any(3072 in shape for shape in e.input_shapes)) / 2e3
    bmm = sum(e.self_device_time_total for e in ops if e.key == "aten::bmm") / 2e3
    out["moe_lm"] = {"wall_ms": wall, "device_ms": busy, "expert_products_ms": expert,
                     "dispatch_and_combine_products_ms": bmm - expert,
                     "by_operator": dict(list(_by_operator(ops).items())[:10])}
    del state, lm_step
    for name, r in out.items():
        shares = (f"; expert products {r['expert_products_ms']:.3f} ms "
                  f"({r['expert_products_ms'] / r['device_ms']:.1%}), dispatch and combine "
                  f"products {r['dispatch_and_combine_products_ms']:.3f} ms "
                  f"({r['dispatch_and_combine_products_ms'] / r['device_ms']:.1%})"
                  if name == "moe_lm" else "")
        print(f"profile: {name} step, wall {r['wall_ms']:.2f} ms, card busy "
              f"{r['device_ms']:.3f} ms (idle {1 - r['device_ms'] / r['wall_ms']:.1%}, an upper "
              f"bound: the profiler's own host cost){shares}; by operator: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in r["by_operator"].items()) + f" on {card}",
              flush=True)
    return out


# the autograd node of K1's backward: in the profiler, everything it launches
K1_BACKWARD_NODE = "autograd::engine::evaluate_function: _CrossEntropyBackward"


def profile_lm_step(card: str, steps: int = 2) -> dict:
    """Where the LM benchmark's step (its published widths, flash
    attention, bf16) goes on the card: the host-clock ms of 10 steps, each
    ended by a host copy of its loss, then one step's peak memory, then
    torch.profiler over `steps` steps: the card's busy ms a step, K1's
    forward kernels' device ms and its backward's (the autograd node
    `_CrossEntropyBackward` with everything it launches), each with its
    share of the busy time. With `--lm-step-profile` this runs alone, on the
    package beside the script (whichever design of K1 that package has)."""
    state = train.create_train_state(_lm_model(), train.default_optimizer(MESH_LR["lm"]))
    step = train.make_lm_train_step(state)
    tokens = _lm_tokens()
    step(tokens)["loss"].item()
    times = _step_ms(step, (tokens,), 10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(tokens)["loss"].item()
    peak = torch.cuda.max_memory_allocated()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        start = time.monotonic()
        for _ in range(steps):
            step(tokens)
        torch.cuda.synchronize()
        wall = (time.monotonic() - start) / steps * 1e3
    rows = prof.key_averages()
    kernels = perf.card_work(rows)
    busy = sum(e.self_device_time_total for e in kernels) / steps / 1e3
    node = [e.device_time_total for e in rows if e.key == K1_BACKWARD_NODE]
    k1_bwd = node[0] / steps / 1e3 if node else None
    k1_fwd = sum(e.self_device_time_total for e in kernels
                 if "ce_fwd" in e.key) / steps / 1e3
    del state, step
    torch.cuda.empty_cache()
    out = {"step_ms_host": times, "peak_memory_bytes": peak, "wall_ms_profiled": wall,
           "device_ms": busy, "k1_forward_device_ms": k1_fwd, "k1_backward_device_ms": k1_bwd,
           "k1_backward_share": None if k1_bwd is None else k1_bwd / busy,
           "k1_forward_share": k1_fwd / busy}
    bwd = ("not measured (no _CrossEntropyBackward row)" if k1_bwd is None
           else f"{k1_bwd:.3f} ms ({k1_bwd / busy:.1%})")
    print(f"profile: LM step 12L/768/seq 1024/batch 8 bf16 (flash attention), host clock "
          f"median {statistics.median(times):.2f} ms {[round(t, 2) for t in times]}, peak "
          f"memory {peak / 1e9:.3f} GB; card busy {busy:.3f} ms a step (wall {wall:.2f} ms "
          f"profiled), K1 forward kernels {k1_fwd:.3f} ms ({k1_fwd / busy:.1%}), K1 backward "
          f"{bwd}, on {card}", flush=True)
    return out


# slice 9: the mesh. The mesh paths' steps (a few: the LM step is host-bound)
MESH_STEPS = dict(steps=5, warmup=1, windows=2)
MESH_LR = {"lm": 3e-2, "resnet50": 0.1}
# the first update of 2 ranks sharing the card (each on half of the batch,
# bf16; for ResNet-50, BatchNorm over the global batch by gloo) against one
# process on the whole batch, as max |d_ranks - d_one| / max |d_one|: the
# bf16 tolerance of VIT_UPDATE_REL (other GEMM shapes round the bf16
# activations at other points; the sums cross ranks in another order)
DP_UPDATE_REL = 5e-2
# ring attention at n = 1 against the plain version on f32 copies of its
# bf16 inputs, relative to the plain version's largest magnitude (at least
# 1), as K2's: the ring rounds its scores to bf16 (its einsum runs in q's
# dtype, as the reference's does) and its output once
RING_REL = 2e-2
# the vocab-parallel loss at n = 1 against the plain f32 loss and gradient
VP_ATOL = 1e-5


def _lm_model():
    """The LM benchmark's model at its published widths (its default
    weights: the seed-0 generator)."""
    return TransformerLM(vocab_size=32768, num_layers=12, num_heads=12, embed_dim=768,
                         max_seq_len=1024, attention_fn=fa.flash_attention)


def _lm_tokens():
    return torch.randint(0, 32768, (8, 1024), generator=torch.Generator(device="cuda")
                         .manual_seed(1), device="cuda", dtype=torch.int32)


def _resnet_model():
    return ResNet50(num_classes=1000, fused_1x1_bwd=True)


def _resnet_batch():
    """The image benchmark's synthetic batch at batch 256, 224x224."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn((256, 224, 224, 3), generator=gen, device="cuda", dtype=torch.bfloat16)
    labels = torch.randint(0, 1000, (256,), generator=gen, device="cuda", dtype=torch.int32)
    return images, labels


MESH_MODELS = {
    "lm": (_lm_model, lambda: (_lm_tokens(),), train.make_lm_train_step),
    "resnet50": (_resnet_model, _resnet_batch, train.make_train_step),
}


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _first_step(name: str, mesh=None, shard=None) -> dict:
    """One step of `name`'s model from its default weights: loss, the
    parameters before and after (this rank's, where `shard` cuts the
    batch)."""
    make_model, make_batch, make_step = MESH_MODELS[name]
    state = train.create_train_state(make_model(), train.default_optimizer(MESH_LR[name]),
                                     "cuda", mesh=mesh)
    step = make_step(state)
    batch = make_batch()
    if shard is not None:
        batch = tuple(shard(x) for x in batch)
    before = _params(state.model)
    loss = step(*batch)["loss"].item()
    return {"loss": loss, "before": before, "after": _params(state.model),
            "state": state, "step": step, "batch": batch}


def _update_diff(ours: dict, ref_after: dict, before: dict) -> tuple[float, float]:
    """(max |ours - ref|, that over the reference's largest update)."""
    diff = max((ours[n] - ref_after[n]).abs().max().item() for n in ours)
    update = max((ref_after[n] - before[n]).abs().max().item() for n in ours)
    return diff, diff / update


def _reduce_ms(state) -> dict:
    """The gradient reduction of a mesh step alone (flatten, all_reduce,
    copies back), by CUDA events and on the card's own clock."""
    def reduce():
        spmd.reduce_gradients(state.model, state.mesh, state.specs,
                              spmd.split_axes(state.mesh, None))

    grads = sum(p.grad.numel() for p in state.model.parameters() if p.grad is not None)
    # two calls behind the sleep: a call launches a copy per parameter
    # (~150-160), and ten would fill the launch queue, which blocks the
    # host until the sleep ends
    return {"ms": _time_ms(reduce, iters=20, warmup=3), "device_ms": _device_ms(reduce, iters=2),
            "gradient_bytes": 4 * grads}


def check_mesh_ops(mesh, card: str) -> dict:
    """`ring_attention` and `vocab_parallel_cross_entropy` at n = 1 on CUDA
    tensors against their plain counterparts."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn(2, 512, 4, 64, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    out = {}
    for causal in (True, False):
        ring = ring_attention(q, k, v, mesh=mesh, axis_name="model", causal=causal)
        ref = attention_reference(q.float(), k.float(), v.float(), causal=causal)
        out[f"ring_causal_{causal}_rel"] = (_max_abs_err(ring, ref)
                                            / max(1.0, ref.abs().max().item()))
    logits = torch.randn(256, 1000, generator=gen, device="cuda").requires_grad_()
    labels = torch.randint(0, 1000, (256,), generator=gen, device="cuda")
    with torch.no_grad():  # a tie: row 0's label shares the row's max
        logits[0, labels[0]] = logits[0, (labels[0] + 1) % 1000] = logits[0].max() + 1
    g = torch.randn(256, generator=gen, device="cuda")
    losses, correct = ce.vocab_parallel_cross_entropy(logits, labels, mesh_lib.mesh_group(mesh, "model"))
    (losses * g).sum().backward()
    ref_losses, ref_correct = ce.cross_entropy_loss_and_correct_reference(logits.detach(), labels)
    ref_grad = (torch.softmax(logits.detach(), -1)
                - F.one_hot(labels.long(), 1000).float()) * g[:, None]
    out["vp_loss_err"] = _max_abs_err(losses, ref_losses)
    out["vp_grad_err"] = _max_abs_err(logits.grad, ref_grad)
    out["vp_correct_equal"] = bool(torch.equal(correct, ref_correct)) and bool(correct[0])
    print(f"mesh ops at n = 1 on the card: ring attention (2, 512, 4, 64) bf16 against the plain "
          f"version on f32 copies, max |err| / max(1, max |plain|) causal {out['ring_causal_True_rel']:.2e}, "
          f"full {out['ring_causal_False_rel']:.2e} (tolerance {RING_REL}); vocab-parallel "
          f"cross-entropy (256, 1000) f32 against the plain loss: max |err| loss "
          f"{out['vp_loss_err']:.2e}, dlogits {out['vp_grad_err']:.2e} (tolerance {VP_ATOL}), "
          f"correct equal (a tie included): {out['vp_correct_equal']}, on {card}", flush=True)
    if not (out["ring_causal_True_rel"] <= RING_REL and out["ring_causal_False_rel"] <= RING_REL
            and out["vp_loss_err"] <= VP_ATOL and out["vp_grad_err"] <= VP_ATOL
            and out["vp_correct_equal"]):
        raise AssertionError(f"mesh ops disagree with their plain versions: {out}")
    return out


def run_mesh_one_rank(card: str, lm_single_ms: float) -> dict:
    """The mesh path at a world of one, over NCCL: a process group of one
    rank from a FileStore, `make_mesh()` (1, 1, 1, 1) on the card. For the
    LM (K2 forward and backward, K1) and ResNet-50 with `fused_1x1_bwd`
    (K4, K1): the first step from the default weights on the mesh against
    the single-device step, whose loss and update it should equal to the
    bit (the reduction over one rank copies); then the benchmarks' mesh
    paths with K1's, K2's and K4's launches counted; the reduction's own
    cost; the mesh ops at n = 1."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1)
        try:
            mesh = mesh_lib.make_mesh(device_type="cuda")
            if tuple(mesh.shape) != (1, 1, 1, 1):
                raise AssertionError(f"make_mesh() at a world of one: {mesh}")
            for name in MESH_MODELS:
                single = _first_step(name)
                ref_loss, ref_after, before = single["loss"], single["after"], single["before"]
                del single
                ours, counts = _counted(lambda: _first_step(name, mesh))
                diff, rel = _update_diff(ours["after"], ref_after, before)
                ours_loss = ours["loss"]
                equal = ours_loss == ref_loss and diff == 0.0
                reduce = _reduce_ms(ours["state"])
                del ours
                spread = None
                if not equal:  # the single-device step's own run-to-run difference
                    again = _first_step(name)
                    spread = _update_diff(again["after"], ref_after, before)[0]
                    del again
                del ref_after, before
                torch.cuda.empty_cache()
                device_ms = ("not measured" if reduce["device_ms"] is None
                             else f"{reduce['device_ms']:.3f} ms")
                print(f"mesh ({name}), one rank over NCCL, first step from the default weights "
                      f"against the single-device step: loss {ours_loss!r} against "
                      f"{ref_loss!r}, equal to the bit (loss and every parameter): {equal}; "
                      f"max |param diff| {diff:.3g} ({rel:.3g} of the largest update); "
                      f"launches in the step {counts}; the gradient reduction alone "
                      f"({reduce['gradient_bytes'] / 1e6:.1f} MB of f32 gradients flattened, "
                      f"all_reduce over one rank, copied back) {reduce['ms']:.3f} ms (device "
                      f"{device_ms}), on {card}", flush=True)
                if not equal:
                    why = ("the card's own run-to-run variation: the single-device step run "
                           f"twice differs by {spread:.3g}" if spread else
                           "not known: the single-device step repeats to the bit")
                    print(f"mesh ({name}): not equal to the bit, the largest parameter "
                          f"difference is {diff:.3g}; why: {why}", flush=True)
                if rel > DP_UPDATE_REL:
                    raise AssertionError(f"mesh ({name}) at one rank: update off by {rel:.3g}")
                out[name] = {"bit_equal": equal, "max_abs_diff": diff, "update_rel": rel,
                             "single_run_to_run": spread, "first_step_launches": counts,
                             "reduce": reduce}
            lm, counts = _counted(lambda: lm_bench.run_benchmark(**MESH_STEPS))
            steps = lm["final_step"]
            if lm["num_chips"] != 1 or (counts["k1"], counts["k1_backward"], counts["k2_forward"],
                                        counts["k2_backward"]) != (
                    steps, steps, 12 * steps, 12 * steps):
                raise AssertionError(f"mesh LM path: {steps} steps, {lm['num_chips']} "
                                     f"ranks, launches {counts}")
            resnet, rcounts = _counted(lambda: run_benchmark(
                model_name="resnet50", batch_per_chip=256, image_size=224, num_classes=1000,
                fused_1x1_bwd=True, **MESH_STEPS))
            rsteps = resnet["final_step"]
            k4_per_step = sum(calls for *_, calls in K4_SHAPES)
            if (rcounts["k1"], rcounts["k1_backward"], rcounts["k4"]) != (
                    rsteps, rsteps, k4_per_step * rsteps):
                raise AssertionError(f"mesh ResNet-50 path: {rsteps} steps, launches {rcounts}")
            for label, r, c, single in (
                    ("LM 12L/768/seq 1024/batch 8", lm, counts,
                     f"the single-device path's {lm_single_ms:.2f} ms earlier in this run"),
                    ("ResNet-50 fused_1x1_bwd batch 256", resnet, rcounts,
                     "the single-device fused path, timed later in this run")):
                print(f"main path on the mesh, one rank over NCCL: {label}, step "
                      f"{r['step_ms']:.2f} ms (windows {r['step_ms_windows']}) against "
                      f"{single}, final loss "
                      f"{r['final_loss']:.6f}, launches in {r['final_step']} steps: K1 "
                      f"{c['k1']} + {c['k1_backward']}, K2 forward {c['k2_forward']}, K2 backward "
                      f"{c['k2_backward']}, K2 input copies {c['k2_copies']}, K4 {c['k4']}, "
                      f"on {card}", flush=True)
            out["lm_path"] = {**counts, "step_ms": lm["step_ms"], "steps": steps}
            out["resnet50_fused_1x1_bwd_path"] = {**rcounts, "step_ms": resnet["step_ms"],
                                                  "steps": rsteps}
            out["ops"] = check_mesh_ops(mesh, card)
        finally:
            dist.destroy_process_group()
    return out


def two_rank_step(name: str, reference_path: str, timed_steps: int) -> dict:
    """One rank of the two-process data-parallel phase (gloo, both on the
    one card): the first step on this rank's half of the batch against the
    one-process step's parameters at `reference_path`, then `timed_steps`
    steps timed on the host clock, the reduction (gloo all_reduce of the
    CUDA gradients) timed apart."""
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = mesh_lib.make_mesh(device_type="cuda")
    reduce_s: list[float] = []
    reduce = spmd.reduce_gradients

    def timed_reduce(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce(*args)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)

    spmd.reduce_gradients = timed_reduce
    try:
        first = _first_step(name, mesh, shard=lambda x: batch_shard(mesh, x))
        ref = torch.load(reference_path, map_location="cuda")
        diff, rel = _update_diff(first["after"], ref["after"], first["before"])
        step, batch = first["step"], first["batch"]
        times = []
        for _ in range(timed_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*batch)["loss"].item()
            times.append(time.perf_counter() - t0)
        reduce_ms = 1e3 * statistics.median(reduce_s[1:])
    finally:
        spmd.reduce_gradients = reduce
    # this rank's kernels in one more step (torch.profiler), after the timing
    _, device_ms, _ = _profile_step(lambda: step(*batch)["loss"].item(), steps=1)
    return {"loss": first["loss"], "ref_loss": ref["loss"], "max_abs_diff": diff,
            "update_rel": rel, "step_ms": 1e3 * statistics.median(times),
            "reduce_ms": reduce_ms, "device_ms": device_ms,
            "batch_per_rank": batch[0].shape[0]}


def two_rank_steps(references: dict, timed_steps: int) -> dict:
    """One rank of the two-process phase: `two_rank_step` of each model in
    `references` ({name: reference path}) in turn, in one process."""
    out = {}
    for name, path in references.items():
        out[name] = two_rank_step(name, path, timed_steps)
        torch.cuda.empty_cache()
    return out


TWO_RANK_MODELS = (("lm", 8 * 1024, "tokens"), ("resnet50", 256, "images"))


def run_two_ranks(card: str) -> dict:
    """Data parallelism in two processes on the one card over gloo: the LM
    (global batch 8, 4 a rank) and ResNet-50 with `fused_1x1_bwd` (256,
    128 a rank, BatchNorm over the global batch), each first step against
    this process's step on the whole batch. One launch of the two ranks
    runs both models, one after the other."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        references = {}
        for name, _, _ in TWO_RANK_MODELS:
            single = _first_step(name)
            references[name] = f"{tmp}/{name}.pt"
            torch.save({"loss": single["loss"], "after": single["after"]}, references[name])
            del single
            torch.cuda.empty_cache()
        by_rank = run_ranks(two_rank_steps, 2, args=(references, 3), backend="gloo",
                            timeout=600, threads=4)
        for name, global_batch, unit in TWO_RANK_MODELS:
            ranks = [rank[name] for rank in by_rank]
            r = ranks[0]
            loss_diff = abs(r["loss"] - r["ref_loss"])
            rate = global_batch / (max(x["step_ms"] for x in ranks) / 1e3)
            print(f"two ranks (gloo) on one card, {name} data parallel, {r['batch_per_rank']} "
                  f"a rank: first-step loss {r['loss']:.6f} against one process's "
                  f"{r['ref_loss']:.6f} (|diff| {loss_diff:.2e}, tolerance {PARITY_LOSS_ATOL}), "
                  f"first update max |diff| {r['max_abs_diff']:.3g} = {r['update_rel']:.3g} of "
                  f"the largest (tolerance {DP_UPDATE_REL}); step {r['step_ms']:.1f} ms wall "
                  f"(rank 1 {ranks[1]['step_ms']:.1f}), of which the gloo gradient all_reduce "
                  f"{r['reduce_ms']:.1f} ms; the card busy with a step's kernels "
                  f"{r['device_ms']:.1f} + {ranks[1]['device_ms']:.1f} ms (rank 0 + rank 1, "
                  f"torch.profiler); {rate:.1f} {unit}/s by two processes sharing one card "
                  f"(not a two-card number), on {card}", flush=True)
            if not (loss_diff <= PARITY_LOSS_ATOL and all(
                    x["update_rel"] <= DP_UPDATE_REL for x in ranks)):
                raise AssertionError(f"two ranks ({name}) disagree with one process: {ranks}")
            out[name] = {"ranks": ranks, "rate_per_s": rate, "unit": unit}
    return out


# slice 10: the pipeline over "pipe", sequence-parallel MoE blocks and
# decode over a mesh
PP_MICROBATCHES = 4
# steps timed on the host clock, each ended by a host copy of its loss
PP_TIMED_STEPS = 5
# the sampled run of the two-process decode
DECODE_TEMPERATURE = 1.5


def _pp_params_as_dense(pp_model) -> dict:
    """A `PipelinedLM`'s parameters at one rank (every stage) under the
    dense LM's names."""
    named = dict(pp_model.named_parameters())
    out = {k.removeprefix("outer."): p.detach().clone() for k, p in named.items()
           if k.startswith("outer.")}
    stages = {k.removeprefix("stages."): p.detach()[0] for k, p in named.items()
              if k.startswith("stages.")}
    out.update({k: v.clone() for k, v in pp.unstack_block_params(stages, pp_model.num_layers)
                .items()})
    return out


def _step_ms(step, batch: tuple, steps: int) -> list[float]:
    """Host-clock ms of each of `steps` steps, each ended by a host copy of
    its loss."""
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        step(*batch)["loss"].item()
        times.append(1e3 * (time.perf_counter() - start))
    return times


def run_pipeline_one_rank(card: str, mesh) -> dict:
    """Phase 24: the pipelined LM at the LM's published widths on the
    (1, 1, 1, 1) mesh, 4 microbatches: its first update against the dense
    single-device step's from the same weights, K1's and K2's launches in
    it, both steps' host-clock times, then where each step goes on the
    card (torch.profiler, after the timing)."""
    single = _first_step("lm")
    ref_after, before, ref_loss = single["after"], single["before"], single["loss"]
    dense_ms = _step_ms(single["step"], single["batch"], PP_TIMED_STEPS)
    state = pp.create_pp_lm_state(_lm_model(), train.default_optimizer(MESH_LR["lm"]), mesh,
                                  "cuda")
    step = pp.make_pp_lm_train_step(state, PP_MICROBATCHES)
    tokens = _lm_tokens()
    loss, counts = _counted(lambda: step(tokens)["loss"].item())
    after = _pp_params_as_dense(state.model)
    num = math.sqrt(sum((after[n] - ref_after[n]).double().norm().item() ** 2 for n in after))
    den = math.sqrt(sum((ref_after[n] - before[n]).double().norm().item() ** 2 for n in after))
    rel = num / den
    pp_ms = _step_ms(step, (tokens,), PP_TIMED_STEPS)
    profiles = {}
    for name, run in (("pipelined", lambda: step(tokens)["loss"].item()),
                      ("dense", lambda: single["step"](*single["batch"])["loss"].item())):
        wall, busy, ops = _profile_step(run)
        profiles[name] = {"wall_ms": wall, "device_ms": busy,
                          "by_operator": dict(list(_by_operator(ops).items())[:8])}
    del state, step, after, ref_after, before, single
    torch.cuda.empty_cache()
    layers = 12
    expected = (1, 1, layers * PP_MICROBATCHES, layers * PP_MICROBATCHES)
    got = (counts["k1"], counts["k1_backward"], counts["k2_forward"], counts["k2_backward"])
    print(f"pipeline (phase 24), one rank over NCCL, LM 12L/768/seq 1024/batch 8 bf16 in "
          f"{PP_MICROBATCHES} microbatches of (2, 1024): first step loss {loss!r} against the "
          f"dense single-device step's {ref_loss!r}; first update |d_pp - d_dense| / |d_dense| "
          f"{rel:.3e} (tolerance {VIT_UPDATE_REL}); launches in the step: K1 {got[0]} + "
          f"{got[1]}, K2 forward {got[2]}, backward {got[3]} (expected {expected}), K2 input "
          f"copies "
          f"{counts['k2_copies']}, peak memory {counts['peak_memory_bytes'] / 1e9:.2f} GB; "
          f"step ms (host clock, {PP_TIMED_STEPS} steps) pipelined median "
          f"{statistics.median(pp_ms):.2f} {[round(t, 2) for t in pp_ms]} against dense median "
          f"{statistics.median(dense_ms):.2f} {[round(t, 2) for t in dense_ms]}, on {card}",
          flush=True)
    for name, r in profiles.items():
        print(f"profile: {name} LM step (phase 24), wall {r['wall_ms']:.2f} ms, card busy "
              f"{r['device_ms']:.3f} ms (idle {1 - r['device_ms'] / r['wall_ms']:.1%}, an upper "
              f"bound: the profiler's own host cost); by operator: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in r["by_operator"].items()) + f" on {card}",
              flush=True)
    if got != expected or not rel <= VIT_UPDATE_REL or abs(loss - ref_loss) > PARITY_LOSS_ATOL:
        raise AssertionError(f"pipeline at one rank: launches {got}, update {rel:.3g}, "
                             f"loss {loss} against {ref_loss}")
    return {**counts, "update_rel": rel, "loss": loss, "dense_loss": ref_loss,
            "step_ms": statistics.median(pp_ms), "step_ms_all": pp_ms,
            "dense_step_ms": statistics.median(dense_ms), "dense_step_ms_all": dense_ms,
            "profiles": profiles}


def run_moe_seq_one_rank(card: str, mesh) -> dict:
    """Phase 25: the MoE LM at the LM's published widths (every second
    block 8 experts) on the (1, 1, 1, 1) mesh, its first step with
    seq_axis="model" (one shard: the slot offsets from an all_gather of
    one, all zero) against the step without a sequence axis: equal to the
    bit."""
    out = {}
    for seq_axis in (None, "model"):
        model = TransformerLM(vocab_size=32768, num_layers=12, num_heads=12, embed_dim=768,
                              max_seq_len=1024, attention_fn=fa.flash_attention,
                              moe_experts=8, moe_every=2, moe_mesh=mesh)
        state = train.create_train_state(model, train.default_optimizer(MESH_LR["lm"]),
                                         "cuda", mesh=mesh)
        step = train.make_lm_train_step(state, seq_axis=seq_axis)
        metrics, counts = _counted(lambda: {k: v.item() for k, v in step(_lm_tokens()).items()})
        out[seq_axis] = {"metrics": metrics, "params": _params(model), "counts": counts}
        del model, state, step
        torch.cuda.empty_cache()
    plain, seq = out[None], out["model"]
    equal = plain["metrics"] == seq["metrics"] and all(
        torch.equal(v, seq["params"][k]) for k, v in plain["params"].items())
    diff = max((v - seq["params"][k]).abs().max().item() for k, v in plain["params"].items())
    print(f"MoE LM with seq_axis='model' (phase 25), one rank over NCCL, 12L/768/seq 1024/batch "
          f"8 bf16, 6 blocks of 8 experts: first step {seq['metrics']} against the step without a "
          f"sequence axis {plain['metrics']}, equal to the bit (metrics and every parameter): "
          f"{equal}, max |param diff| {diff:.3g}; launches K1 {seq['counts']['k1']} + "
          f"{seq['counts']['k1_backward']}, K2 "
          f"{seq['counts']['k2_forward']} + {seq['counts']['k2_backward']}, on {card}",
          flush=True)
    if not equal:
        raise AssertionError("MoE LM: the step with a sequence axis of one differs")
    launches = {k: seq["counts"][k] for k in ("k1", "k1_backward", "k2_forward", "k2_backward")}
    if tuple(launches.values()) != (1, 1, 12, 12):
        raise AssertionError(f"MoE LM with seq_axis: launches {launches} in one step")
    return {"bit_equal": equal, "metrics": seq["metrics"], **launches}


def run_decode_mesh_one_rank(card: str, single: dict) -> dict:
    """Phase 26, first part: the decode benchmark at DECODE_DEPTH with the
    int8 cache on the (1, 1, 1, 1) mesh over NCCL: the tokens of phase
    13's single-device run, K3 12 x 63 times a call."""
    da.decode_attention_kernel.launches = 0
    result = decode_bench.run_benchmark(cache_int8=True, keep_tokens=True, **DECODE_DEPTH)
    launches = da.decode_attention_kernel.launches
    # the first call and the timed repeats
    expected = result["num_layers"] * (result["new_tokens"] - 1) * (1 + DECODE_DEPTH["repeats"])
    equal = result["tokens"] == single["tokens"]
    print(f"decode over the mesh (phase 26), one rank over NCCL, {result['new_tokens']} new "
          f"tokens with the int8 cache: "
          f"num_chips {result['num_chips']}, {result['tokens_per_sec']:.1f} tokens/s, "
          f"{result['ms_per_token_per_stream']:.3f} ms a step against the single-device run's "
          f"{single['ms_per_token_per_stream']:.3f}; tokens equal the single-device run's: "
          f"{equal}; K3 launches {launches} (expected {expected}), on {card}", flush=True)
    if not equal or result["num_chips"] != 1 or launches != expected:
        raise AssertionError(f"decode over the mesh: tokens equal {equal}, launches {launches}")
    return {"k3": launches, "tokens_per_sec": result["tokens_per_sec"],
            "ms_per_token_per_stream": result["ms_per_token_per_stream"]}


def two_rank_decode(options: dict) -> dict:
    """One rank of the two-process decode (gloo, both on the one card): the
    benchmark with the int8 cache on this rank's 4 of the 8 streams, greedy
    and then sampled at DECODE_TEMPERATURE."""
    torch.cuda.set_device(0)
    da.decode_attention_kernel.launches = 0
    result = decode_bench.run_benchmark(cache_int8=True, keep_tokens=True, **options)
    k3 = da.decode_attention_kernel.launches
    sampled = decode_bench.run_benchmark(cache_int8=True, keep_tokens=True,
                                         temperature=DECODE_TEMPERATURE, **options)
    return {**result, "k3": k3, "sampled_tokens": sampled["tokens"]}


def run_two_rank_decode(card: str) -> dict:
    """Phase 26, second part: two processes sharing the card over gloo, 4
    of 8 streams each; each rank's tokens against this process's
    `generate` of the same 4 rows."""
    ranks = run_ranks(two_rank_decode, 2, args=(DECODE_DEPTH,), backend="gloo", timeout=600,
                      threads=4)
    new = DECODE_DEPTH["new_tokens"]
    max_len = 128 + new
    model = TransformerLM(vocab_size=32768, num_layers=12, num_heads=12, embed_dim=768,
                          max_seq_len=max_len, generator=torch.Generator().manual_seed(1))
    params = dec.lm_params(model, "cuda")
    prompt = torch.randint(0, 32768, (8, 128), generator=torch.Generator().manual_seed(0))
    equal = [dec.generate(model, params, prompt[4 * r:4 * r + 4].cuda(), new, max_len=max_len,
                          cache_int8=True).cpu().tolist() == ranks[r]["tokens"] for r in range(2)]
    # sampled: each rank's rows of one process's run on the 8 streams with
    # the same seed (every rank draws the whole batch's noise)
    single = decode_bench.run_benchmark(cache_int8=True, keep_tokens=True,
                                        temperature=DECODE_TEMPERATURE, **DECODE_DEPTH)
    sampled_equal = [single["tokens"][4 * r:4 * r + 4] == ranks[r]["sampled_tokens"]
                     for r in range(2)]
    distinct = single["tokens"][:4] != single["tokens"][4:]
    print(f"sampled decode in two processes (gloo) on one card (phase 26), temperature "
          f"{DECODE_TEMPERATURE}: each rank's tokens equal its rows of one process's run on the 8 "
          f"streams with the same seed: {sampled_equal}; the halves differ: {distinct}, on "
          f"{card}", flush=True)
    if not (all(sampled_equal) and distinct):
        raise AssertionError(f"sampled two-process decode: equal {sampled_equal}, halves "
                             f"differ {distinct}")
    r = ranks[0]
    expected = 12 * (new - 1) * (1 + DECODE_DEPTH["repeats"])
    print(f"decode in two processes (gloo) on one card (phase 26), 4 of 8 streams each, "
          f"{new} new tokens, int8 cache: num_chips {r['num_chips']}, {r['tokens_per_sec']:.1f} "
          f"tokens/s by two processes sharing one card (not a two-card number; the slowest "
          f"rank's time), {r['ms_per_token_per_stream']:.3f} ms a step; each rank's tokens equal "
          f"this process's generate of its 4 rows: {equal}; K3 launches {r['k3']} + "
          f"{ranks[1]['k3']} (expected {expected} each), on {card}", flush=True)
    if not all(equal) or r["num_chips"] != 2 or any(x["k3"] != expected for x in ranks):
        raise AssertionError(f"two-process decode: equal {equal}, ranks {ranks}")
    return {"k3": [x["k3"] for x in ranks], "tokens_per_sec": r["tokens_per_sec"],
            "ms_per_token_per_stream": r["ms_per_token_per_stream"],
            "sampled_equal": sampled_equal}


def run_slice10(card: str, decode_single: dict) -> dict:
    """Phases 24-26: a process group of one rank over NCCL for the
    pipeline, the MoE LM's sequence axis and decode over the mesh; then
    decode in two processes over gloo."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1)
        try:
            mesh = mesh_lib.make_mesh(device_type="cuda")
            out["pipeline"] = run_pipeline_one_rank(card, mesh)
            out["moe_seq_axis"] = run_moe_seq_one_rank(card, mesh)
            out["decode_mesh"] = run_decode_mesh_one_rank(card, decode_single)
        finally:
            dist.destroy_process_group()
    out["decode_two_ranks"] = run_two_rank_decode(card)
    return out


# slice 11: the elastic trainer at full width, and the train drill's SIGKILL
ELASTIC_STEPS = 6
# the generation goes 1 -> 2 at this step's boundary
ELASTIC_BUMP_AT = 3
ELASTIC_EVERY = 2
# the drill in two processes: long enough that the kill lands mid-run
DRILL_STEPS = 400
DRILL_EVERY = 25
# a phase of the drill that does not finish in this time fails
DRILL_TIMEOUT_S = 300.0


def _elastic_tokens(step: int) -> torch.Tensor:
    """Step `step`'s batch of the LM of 7: the same in every run."""
    return torch.randint(0, 32768, (8, 1024), generator=torch.Generator(device="cuda")
                         .manual_seed(1000 + step), device="cuda", dtype=torch.int32)


def _lm_values(state) -> dict:
    out = {f"param.{n}": p.detach().clone() for n, p in state.model.named_parameters()}
    for n, p in state.model.named_parameters():
        out[f"momentum.{n}"] = state.optimizer.state[p]["momentum_buffer"].clone()
    return out


class _AckLog(elastic.JobAck):
    """The job-ack file, with the phases written in order."""

    def __init__(self, path) -> None:
        super().__init__(path)
        self.phases: list[str] = []

    def write(self, phase: str, *args, **kwargs) -> None:
        super().write(phase, *args, **kwargs)
        self.phases.append(phase)


class _TimedCheckpoint(elastic.ElasticCheckpoint):
    """ElasticCheckpoint with its saves' and restores' seconds kept."""

    def __init__(self, factory) -> None:
        super().__init__(factory)
        self.seconds: dict[str, list[float]] = {"save": [], "restore": []}

    def save(self, step: int, state) -> None:
        t0 = time.monotonic()
        super().save(step, state)
        torch.cuda.synchronize()
        self.seconds["save"].append(time.monotonic() - t0)

    def restore(self, state, shardings=None, step=None):
        t0 = time.monotonic()
        out = super().restore(state, shardings, step)
        torch.cuda.synchronize()
        self.seconds["restore"].append(time.monotonic() - t0)
        return out


def run_elastic_one_rank(card: str) -> dict:
    """Phase 27: `parallel/elastic.ElasticTrainer` driving the LM of 7 at its
    published widths (K1, K2) on a one-rank mesh over NCCL. A scripted
    fleet status bumps the generation 1 -> 2 at the step-3 boundary of 6:
    the trainer flushes a real `TrainCheckpointer` checkpoint, leaves the
    group (`distributed.shutdown`), forms a new one-rank group, rebuilds
    the state from fresh weights and restores. Its final parameters and
    momentum must equal an uninterrupted 6-step run's to the bit, with one
    resume, 0 steps lost, acks notified -> resumed, and K1 once and K2
    12 + 12 times a step."""
    with tempfile.TemporaryDirectory() as tmp:
        stores = iter(range(1000))

        def join():
            dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store{next(stores)}", 1),
                                    rank=0, world_size=1)
            return None  # the world of one the trainer reports

        def setup() -> elastic.TrainSession:
            mesh = mesh_lib.make_mesh(device_type="cuda")
            state = train.create_train_state(_lm_model(), train.default_optimizer(MESH_LR["lm"]),
                                             "cuda", mesh=mesh)
            return elastic.TrainSession(state, None,
                                        elastic.state_step_fn(train.make_lm_train_step(state)),
                                        mesh)

        def batch_fn(session, step: int) -> tuple:
            return (_elastic_tokens(step),)

        # the uninterrupted run, on the same mesh path
        join()
        try:
            session = setup()
            times = []
            for i in range(ELASTIC_STEPS):
                t0 = time.monotonic()
                session.step_fn(session.state, *batch_fn(session, i))[1]["loss"].item()
                times.append(1e3 * (time.monotonic() - t0))
            straight = _lm_values(session.state)
            del session
        finally:
            distributed.shutdown()
        torch.cuda.empty_cache()

        views = ([elastic.FleetView(generation=1, heal_in_progress=False, verdict="healthy")]
                 * (ELASTIC_BUMP_AT + 1)
                 + [elastic.FleetView(generation=2, heal_in_progress=False, verdict="healthy")])
        ack = _AckLog(f"{tmp}/job-ack.json")
        ckpt = _TimedCheckpoint(lambda: ckpt_lib.TrainCheckpointer(f"{tmp}/ckpt"))
        trainer = elastic.ElasticTrainer(
            setup, batch_fn, checkpoint=ckpt, health=elastic.ScriptedHealthSource(views),
            policy=elastic.ElasticPolicy(checkpoint_every=ELASTIC_EVERY), ack=ack,
            init_fn=join, shutdown_fn=distributed.shutdown, drain_fn=None,
            echo=lambda line: print(f"phase 27: {line}", flush=True))
        try:
            report, counts = _counted(lambda: trainer.run(ELASTIC_STEPS))
            resumed = _lm_values(trainer.session.state)
            final_step = trainer.session.state.step
        finally:
            trainer.session = None
            distributed.shutdown()
    diffs = [(resumed[k] - v).abs().max().item() for k, v in straight.items()]
    max_diff = max(diffs)
    resume = report["resumes"][0] if report["resumes"] else None
    reconfigure_s = resume["ts"] - resume["notice_ts"] if resume else float("nan")
    out = {"report": report, "ack_phases": ack.phases, "max_abs_diff": max_diff,
           "bit_equal": max_diff == 0.0, "final_step": final_step, "launches": counts,
           "step_ms": times, "save_s": ckpt.seconds["save"],
           "restore_s": ckpt.seconds["restore"], "reconfigure_s": reconfigure_s}
    print(f"elastic trainer (phase 27), LM 12L/768/seq 1024/batch 8 bf16 on a one-rank NCCL mesh, "
          f"generation 1 -> 2 at step {ELASTIC_BUMP_AT} of {ELASTIC_STEPS}: resumes "
          f"{len(report['resumes'])}, steps lost {report['steps_lost']}, acks {ack.phases}; final "
          f"parameters and momentum against an uninterrupted run: max |diff| {max_diff!r} "
          f"(tolerance 0); launches in the trainer's run {counts}; uninterrupted step ms "
          f"{[round(t, 2) for t in times]} (host clock, each ended by loss.item()); saves "
          f"{[round(t, 3) for t in ckpt.seconds['save']]} s, restore "
          f"{[round(t, 3) for t in ckpt.seconds['restore']]} s, reconfigure (flush, leave, "
          f"rejoin, rebuild, restore) {reconfigure_s:.3f} s, on {card}", flush=True)
    if (len(report["resumes"]) != 1 or report["steps_lost"] != 0 or final_step != ELASTIC_STEPS
            or ack.phases != ["notified", "resumed"] or max_diff != 0.0):
        raise AssertionError(f"elastic trainer at a world of one: {out}")
    if (counts["k1"], counts["k1_backward"], counts["k2_forward"], counts["k2_backward"]) != (
            ELASTIC_STEPS, ELASTIC_STEPS, 12 * ELASTIC_STEPS, 12 * ELASTIC_STEPS):
        raise AssertionError(f"elastic trainer: launches {counts} in {ELASTIC_STEPS} steps")
    return out


def _write_json(path: pathlib.Path, doc: dict) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(doc))
    tmp.replace(path)


def _fleet_status(generation: int, degraded: list[int]) -> dict:
    return {"verdict": "degraded" if degraded else "healthy", "updated": time.time(),
            "membership": {"generation": generation, "heal_in_progress": False,
                           "draining": []}, "degraded": degraded}


def _wait_for(predicate, what: str, procs) -> float:
    """Poll `predicate` until it holds; its time on the monotonic clock.
    Fails at DRILL_TIMEOUT_S or when a process ends first."""
    deadline = time.monotonic() + DRILL_TIMEOUT_S
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"SIGKILL drill: {what} did not happen in {DRILL_TIMEOUT_S} s")
        if any(p.poll() is not None for p in procs):
            raise AssertionError(f"SIGKILL drill: a process ended before {what}: "
                                 + "\n".join(p.communicate()[0][-3000:] for p in procs
                                             if p.poll() is not None))
        time.sleep(0.01)
    return time.monotonic()


def run_sigkill_drill(card: str) -> dict:
    """Phase 28: two processes of `cli.main train --device cuda --backend
    gloo` (NCCL refuses two ranks on one card), their coordinates from the
    `JAX_*` env contract. After the first committed checkpoint, process 1
    is SIGKILLed as a process group. Once the survivor acknowledges
    `notified` (its step's gloo all_reduce failed), the fleet status says
    generation 2 with slice 1 degraded and the env file names one process.
    The survivor must rejoin at world size 1, restore the state two ranks
    saved, and reach the last step having lost at most one checkpoint
    interval, acknowledging degraded or resumed."""
    root = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        status, env_file, ckpt = tmp / "fleet-status.json", tmp / "cluster.env", tmp / "ckpt"
        _write_json(status, _fleet_status(1, []))
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        base = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "TK8S_"))}
        procs = []
        try:
            for pid in (0, 1):
                argv = [sys.executable, "-m", "tritonk8ssupervisor_tpu_torch.cli.main", "train",
                        "--device", "cuda", "--backend", "gloo", "--workdir", str(tmp),
                        "--checkpoint-dir", str(ckpt), "--steps", str(DRILL_STEPS),
                        "--checkpoint-every", str(DRILL_EVERY), "--status-file", str(status),
                        "--ack-file", str(tmp / f"ack-{pid}.json"), "--env-file", str(env_file),
                        "--max-wait", "60", "--max-degraded", "1",
                        "--train-report", str(tmp / f"report-{pid}.json"), "--yes"]
                env = {**base, "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                       "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(pid),
                       "OMP_NUM_THREADS": "2"}
                procs.append(subprocess.Popen(argv, env=env, cwd=root, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True,
                                              start_new_session=True))
            markers = ckpt / ckpt_lib.COMMIT_DIR
            started = time.monotonic()
            _wait_for(lambda: markers.is_dir() and any(int(m.name) >= DRILL_EVERY
                                                        for m in markers.iterdir()),
                      "a committed checkpoint", procs)
            committed = max(int(m.name) for m in markers.iterdir())
            os.killpg(procs[1].pid, signal.SIGKILL)
            killed = time.monotonic()
            # the step both processes saved (the survivor prunes it later)
            two_rank_files = len(list((ckpt / str(committed)).glob("*.distcp")))
            ack = tmp / "ack-0.json"

            def acked(phase: str) -> bool:
                try:
                    return json.loads(ack.read_text())["phase"] == phase
                except (OSError, ValueError):
                    return False

            notified = _wait_for(lambda: acked("notified"), "the survivor's notified ack",
                                 procs[:1])
            # the supervisor's side: slice 1 gone, no heal coming, one process
            env_file.write_text("JAX_NUM_PROCESSES=1\nJAX_PROCESS_ID=0\n")
            _write_json(status, _fleet_status(2, [1]))
            out = procs[0].communicate(timeout=DRILL_TIMEOUT_S)[0]
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=30)
        if procs[0].returncode != 0:
            raise AssertionError(f"SIGKILL drill: the survivor failed:\n{out[-4000:]}")
        report = json.loads((tmp / "report-0.json").read_text())
        final_ack = json.loads(ack.read_text())
    resume = report["resumes"][0] if report["resumes"] else {}
    result = {"report": report, "final_ack": final_ack["phase"],
              "first_committed_step": committed, "killed_after_s": killed - started,
              "kill_to_notified_s": notified - killed,
              # the survivor's resume stamp is on the host's monotonic clock
              "kill_to_resume_s": resume.get("ts", float("nan")) - killed,
              "files_in_two_rank_step": two_rank_files}
    print(f"SIGKILL drill (phase 28), two processes of cli.main train --device cuda "
          f"--backend gloo on one card, {DRILL_STEPS} steps, checkpoint every {DRILL_EVERY}: "
          f"process 1 killed after step {committed} committed; the survivor acknowledged "
          f"notified {result['kill_to_notified_s']:.3f} s after the kill (its failed all_reduce), "
          f"resumed {result['kill_to_resume_s']:.3f} s after it (the fleet status was rewritten "
          f"once it acknowledged), at step {resume.get('resumed_step')} of "
          f"{resume.get('at_step')} (lost {report['steps_lost']}), world size "
          f"{report['world']}, final step {report['final_step']}, last ack "
          f"{final_ack['phase']}, on {card}", flush=True)
    if not (report["final_step"] == DRILL_STEPS and report["world"] == 1
            and len(report["resumes"]) == 1 and report["steps_lost"] <= DRILL_EVERY
            and final_ack["phase"] in ("degraded", "resumed") and two_rank_files == 2
            and resume.get("resumed_step", -1) >= committed):
        raise AssertionError(f"SIGKILL drill: {result}")
    return result


def run_slice11(card: str) -> dict:
    """Phases 27-28."""
    return {"elastic_one_rank": run_elastic_one_rank(card), "sigkill_drill": run_sigkill_drill(card)}


# ---------------------------------------------------------------------------
# Phase 29: the serving plane at full width on the card

SERVE_SLOTS = 4
SERVE_MAX_LEN = 512
SERVE_PREFIX = 192  # the shared system prompt, as the engine benchmark's
SERVE_NEW_TOKENS = 32  # cut from 64 to keep the whole script inside its time limit
SERVE_SPEC_K = 4
SERVE_REQUESTS = 16
# the drill's prompts, cycled over its requests: (tokens of the shared
# prefix, a whole number of pages; then tokens of its own), 64-256 in all
SERVE_PROMPTS = ((48, 16), (112, 16), (192, 8), (192, 64))
# a drill that has not settled in this time fails the phase
SERVE_TIMEOUT_S = 180.0
# a trace's queue-wait + prefill + decode against the key's latency_s: the
# four come from the same three timestamps, each rounded to 1e-6 s
ANALYZE_PHASE_ATOL_S = 1e-5
HTTP_TIMEOUT_S = 120


def _serving_models():
    """The LM at its published widths and the engine benchmark's drafter
    (1 layer, 2 heads, embed 32, from the same seeds), on the card. The
    benchmark's shared lm_head bias is left out: it makes every greedy
    token the bias's top token, which would leave the token-identity
    check nothing to compare. Without it the drafter's proposals are
    rejected and every round rolls back."""
    model = TransformerLM(vocab_size=32768, num_layers=12, num_heads=12, embed_dim=768,
                          max_seq_len=SERVE_MAX_LEN, generator=torch.Generator().manual_seed(1))
    draft = TransformerLM(vocab_size=32768, num_layers=1, num_heads=2, embed_dim=32,
                          max_seq_len=SERVE_MAX_LEN, generator=torch.Generator().manual_seed(5))
    return model, dec.lm_params(model, "cuda"), draft, dec.lm_params(draft, "cuda")


def _serving_prompts() -> tuple[list, np.ndarray]:
    """The drill's prompts and the warm-up prompt (the whole prefix and 16
    tokens of its own) that seeds the prefix store before either run, so
    that every request matches the same prefix pages in the drill and in
    the engine alone, and prefills the same chunks."""
    rng = np.random.default_rng(29)
    prefix = rng.integers(0, 32768, SERVE_PREFIX)

    def prompt(shared: int, own: int) -> np.ndarray:
        return np.concatenate([prefix[:shared], rng.integers(0, 32768, own)]).astype(np.int32)

    prompts = [prompt(*SERVE_PROMPTS[i % len(SERVE_PROMPTS)]) for i in range(SERVE_REQUESTS)]
    return prompts, prompt(SERVE_PREFIX, 16)


def _serving_engine(model, params, draft, draft_params, tracer=None,
                    slice_index: int = 0) -> SlotEngine:
    return SlotEngine(model, params, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                      prefill_chunk=64, page_size=K3_PAGE_SIZE, cache_int8=True,
                      draft_model=draft, draft_params=draft_params, spec_k=SERVE_SPEC_K,
                      tracer=tracer, slice_index=slice_index)


def _percentile(values: list, q: float) -> float:
    """The gateway's percentile (`GatewayMetrics.percentile`): the sample
    at round(q * (n - 1)) of the sorted values."""
    values = sorted(values)
    return values[min(len(values) - 1, max(0, int(round(q * (len(values) - 1)))))]


def _serving_policy():
    return gateway_mod.GatewayPolicy(
        max_seq_len=SERVE_MAX_LEN, slots_per_slice=SERVE_SLOTS, prefill_chunk=64,
        bucket_bounds=(64, 128, 256), page_size=K3_PAGE_SIZE, spec_k=SERVE_SPEC_K)


def _check_serving(what: str, report: dict, crashed) -> None:
    """The phase fails on an engine crash, an expiry or a requeue: the
    engine loop's containment must not hide a CUDA error on the card."""
    if (crashed is not None or report["serving"]["engine_failures"]
            or report["expired"] or report["requeued_after_slice_loss"]):
        raise AssertionError(
            f"{what}: engine crashed {crashed!r}, engine failures "
            f"{report['serving']['engine_failures']}, expired {report['expired']}, requeued "
            f"{report['requeued_after_slice_loss']}")


def _http_generate(port: int, doc: dict) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT_S)
    try:
        conn.request("POST", "/generate", body=json.dumps(doc),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _http_get(port: int, path: str) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT_S)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def check_http(gateway, prompts: list, alone: list) -> dict:
    """`make_handler` on a ThreadingHTTPServer on port 0 over the drill's
    gateway, as tests/test_serving.py starts it: /healthz 200, a plain and
    a streamed /generate equal to the engine alone for their prompt, a 400
    for an over-long prompt, /metrics with the completion counter and the
    step histogram."""
    lock = threading.Lock()
    loop = server.EngineLoop(gateway, lock)
    http_server = ThreadingHTTPServer(("127.0.0.1", 0),
                                      server.make_handler(gateway, lock, loop=loop))
    port = http_server.server_address[1]
    thread = threading.Thread(target=http_server.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
    # the 200- and 64-token prompts: the pages of their own tokens that the
    # drill registered lie past their match cap (prompt_len - 1 tokens), so
    # they match the same prefix pages as in the engine alone and prefill
    # the same chunks. A longer match moves the chunk boundaries, and a
    # position inside the chunk attends its fresh K/V where it would read
    # the int8 pool: other bits, and bf16 logits tie often enough at this
    # width for that to change a greedy token
    plain_i = SERVE_PROMPTS.index((192, 8))
    stream_i = SERVE_PROMPTS.index((48, 16))
    loop.start()
    thread.start()
    try:
        health, _ = _http_get(port, "/healthz")
        status, body = _http_generate(port, {"tokens": prompts[plain_i].tolist(),
                                             "max_new_tokens": SERVE_NEW_TOKENS})
        plain = json.loads(body)["tokens"] if status == 200 else None
        stream_status, body = _http_generate(port, {"tokens": prompts[stream_i].tolist(),
                                                    "max_new_tokens": SERVE_NEW_TOKENS,
                                                    "stream": True})
        lines = [json.loads(line) for line in body.decode().splitlines()]
        streamed = [t for line in lines[:-1] for t in line["tokens"]]
        streamed_tail = lines[-1].get("tokens") if lines else None
        too_long, _ = _http_generate(port, {"tokens": [1] * (SERVE_MAX_LEN + 1),
                                            "max_new_tokens": 4})
        metrics_status, metrics_body = _http_get(port, "/metrics")
    finally:
        http_server.shutdown()
        http_server.server_close()
        loop.stop()
    text = metrics_body.decode()
    out = {"healthz": health, "plain_status": status, "stream_status": stream_status,
           "too_long": too_long, "metrics_status": metrics_status,
           "plain_equal": plain == alone[plain_i],
           "stream_equal": streamed == streamed_tail == alone[stream_i],
           "stream_chunks": len(lines) - 1,
           "metrics_has": all(name in text for name in ("serving_requests_completed_total",
                                                         "serving_engine_step_seconds"))}
    if not (health == status == stream_status == metrics_status == 200 and too_long == 400
            and out["plain_equal"] and out["stream_equal"] and out["metrics_has"]):
        raise AssertionError(f"HTTP over the full-width gateway: {out}")
    _check_serving("HTTP", gateway.report(), loop.crashed)
    return out


def check_recover(workdir: pathlib.Path, engine, results: dict) -> dict:
    """A gateway restarted on the drill's request log: `recover()` makes the
    completed keys answerable; a resubmitted key is answered `replayed`
    with the recorded tokens (`results`: key -> the journal's tokens), and
    the engine takes no step for it."""
    gateway = gateway_mod.Gateway(
        {0: engine}, None, policy=_serving_policy(),
        reqlog=reqlog.RequestLog(RunPaths(workdir).request_log, echo=lambda line: None))
    counts = gateway.recover(time.monotonic())
    key = sorted(results)[0]
    steps, launches = engine.steps, da.decode_attention_kernel.launches
    admission = gateway.submit(gateway_mod.Request(
        rid=99, prompt_len=4, max_new_tokens=SERVE_NEW_TOKENS,
        tokens=np.arange(4, dtype=np.int32), key=key), time.monotonic())
    out = {"recover": counts, "key": key, "reason": admission.reason,
           "tokens_equal": (admission.result or {}).get("tokens") == results[key],
           "engine_steps": engine.steps - steps,
           "k3_launches": da.decode_attention_kernel.launches - launches}
    if not (admission.reason == gateway_mod.REPLAYED and out["tokens_equal"]
            and out["engine_steps"] == out["k3_launches"] == 0
            and counts["completed_cached"] == SERVE_REQUESTS and counts["redone"] == 0):
        raise AssertionError(f"recover over the drill's journal: {out}")
    return out


def run_cli_drill(workdir: pathlib.Path) -> dict:
    """`cli.main serve --drill 8` on the card at the reference's drill size
    (its own f32 model and drafter); its output goes to a buffer, its last
    line is printed."""
    report_path = workdir / "cli-report.json"
    buffer = io.StringIO()
    with contextlib.redirect_stdout(buffer):
        rc = cli.main(["serve", "--drill", "8", "--workdir", str(workdir),
                       "--serve-report", str(report_path)])
    report = json.loads(report_path.read_text())
    out = {"rc": rc, "completed": report["completed"], "submitted": report["submitted"],
           "tokens_generated": report["tokens_generated"],
           "p50_latency_s": report["p50_latency_s"], "last_line": buffer.getvalue()
           .strip().splitlines()[-1]}
    if rc != 0 or not report["completed"] == report["submitted"] == 8:
        raise AssertionError(f"cli.main serve --drill 8: {out}")
    _check_serving("the CLI drill", report, None)
    return out


def check_analyzers(workdir: pathlib.Path, tracer, keys: list, prefill_tokens: int) -> dict:
    """`cli.main trace KEY --json` in process for each drill key: exit 0,
    complete, written by this process alone, its queue-wait, prefill and
    decode phases summing to the key's `complete` span's latency (the
    gateway emits all four from the same timestamps); the `prefill-chunk`
    spans of the drill's keys carry `prefill_tokens` tokens (the engine's
    counter over the drill); `trace` of an unknown key exits 2; and `python
    -m ...cli.main analyze --correlate --json` in a subprocess counts the
    drill's completions and no ledger record, so a spike it reports has no
    fleet event to overlap. The span log is flushed before either reads."""
    spans = tracer.log.spans()  # replay flushes the live writer
    latency = {s["key"]: s["latency_s"] for s in spans if s["span"] == "complete"}
    chunk_tokens = sum(s["tokens"] for s in spans
                       if s["span"] == "prefill-chunk" and s["key"] in set(keys))
    trace_s, worst = [], 0.0
    for key in keys:
        buffer = io.StringIO()
        start = time.monotonic()
        with contextlib.redirect_stdout(buffer):
            rc = cli.main(["trace", key, "--json", "--workdir", str(workdir)])
        trace_s.append(time.monotonic() - start)
        doc = json.loads(buffer.getvalue())
        phases = doc["phases"]
        gap = abs(sum(phases.get(name, math.nan) for name in ("queue-wait", "prefill", "decode"))
                  - latency[key])
        worst = max(worst, gap)
        if (rc != 0 or not doc["complete"] or doc["incarnations"] != [os.getpid()]
                or not gap <= ANALYZE_PHASE_ATOL_S):
            raise AssertionError(f"trace {key}: rc {rc}, complete {doc['complete']}, "
                                 f"incarnations {doc['incarnations']}, phases {phases} "
                                 f"against latency {latency[key]}")
    if chunk_tokens != prefill_tokens:
        raise AssertionError(f"prefill-chunk spans of the drill's keys carry {chunk_tokens} "
                             f"tokens, the engine prefilled {prefill_tokens}")
    with contextlib.redirect_stdout(io.StringIO()):
        missing_rc = cli.main(["trace", "no-such-key", "--workdir", str(workdir)])
    if missing_rc != 2:
        raise AssertionError(f"trace no-such-key exited {missing_rc}, not 2")
    start = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "tritonk8ssupervisor_tpu_torch.cli.main", "analyze",
         "--correlate", "--json", "--workdir", str(workdir)],
        capture_output=True, text=True, timeout=120, cwd=pathlib.Path(__file__).resolve().parent)
    analyze_s = time.monotonic() - start
    if out.returncode != 0:
        raise AssertionError(f"analyze exited {out.returncode}: {out.stderr[-2000:]}")
    doc = json.loads(out.stdout)
    cor = doc["correlate"]
    no_event = "no overlapping fleet event on record"
    if (doc["spans_by_kind"].get("serving/complete") != len(keys)
            or cor["completions"] != len(keys) or doc["ledger_records"] != 0
            or cor["fleet_intervals"] != 0
            or any(no_event not in line for line in cor["attributions"])):
        raise AssertionError(f"analyze --correlate: {json.dumps(doc, sort_keys=True)[:2000]}")
    result = {"keys": len(keys), "max_phase_gap_s": worst, "prefill_chunk_tokens": chunk_tokens,
              "trace_ms_mean": statistics.mean(trace_s) * 1e3, "trace_ms_max": max(trace_s) * 1e3,
              "analyze_subprocess_s": analyze_s, "spans": doc["spans"],
              "spans_by_kind": doc["spans_by_kind"], "spikes": len(cor["spikes"]),
              "overall_p50_s": cor["overall_p50_s"], "overall_p99_s": cor["overall_p99_s"]}
    print(f"analyzers (phase 29): trace of {len(keys)} keys complete, phases = latency within "
          f"{worst:.2e} s, {chunk_tokens} prefill-chunk tokens = the engine's; trace in process "
          f"{result['trace_ms_mean']:.2f} ms mean, {result['trace_ms_max']:.2f} ms max; analyze "
          f"--correlate subprocess {analyze_s:.2f} s over {doc['spans']} spans, "
          f"{cor['completions']} completions, {len(cor['spikes'])} spike window(s), 0 ledger "
          f"records", flush=True)
    return result


def run_serving_plane(card: str) -> dict:
    """Phase 29: the gateway over the full-width int8-cache `SlotEngine` with
    a drafter, journal and telemetry wired as `cli.main serve` wires them
    (spans and journal records fsync'd): a 16-request drill token-identical
    to the engine alone, K3 counted around it; HTTP; recover; the CLI
    drill."""
    started = time.monotonic()
    model, params, draft, draft_params = _serving_models()
    prompts, warm = _serving_prompts()
    with tempfile.TemporaryDirectory() as tmp:
        workdir = pathlib.Path(tmp)
        paths = RunPaths(workdir)
        telemetry = obs.Telemetry.for_run(paths, clock=time.monotonic, incarnation=os.getpid(),
                                          echo=lambda line: print(line, flush=True))
        engine = _serving_engine(model, params, draft, draft_params, telemetry.tracer)
        decode_bench.drive(engine, [warm], 1)  # seeds the prefix store
        prefill_before = engine.prefill_tokens
        gateway = gateway_mod.Gateway(
            {0: engine}, None, policy=_serving_policy(),
            reqlog=reqlog.RequestLog(paths.request_log, echo=lambda line: print(line)),
            telemetry=telemetry, demand_path=paths.demand_signal)
        gateway.recover(time.monotonic())
        da.decode_attention_kernel.launches = 0
        drill_start = time.monotonic()
        report = server.run_drill(gateway, SERVE_REQUESTS, vocab_size=32768,
                                  max_new_tokens=SERVE_NEW_TOKENS, prompts=prompts,
                                  timeout_s=SERVE_TIMEOUT_S)
        drill_s = time.monotonic() - drill_start
        launched = da.decode_attention_kernel.launches
        crashed = telemetry.metrics.get("serving_engine_crashed").value()
        _check_serving("the drill", report, None if not crashed else "the crash gauge is 1")
        if report["completed"] != SERVE_REQUESTS or launched == 0:
            raise AssertionError(f"drill: {report['completed']} of {SERVE_REQUESTS} completed, "
                                 f"K3 launches {launched}")
        served = [r["tokens"] for r in report["results"]]
        completed = gateway.metrics.completed
        ttft = [r.first_token_at - r.arrival for r in completed]
        # read now: the HTTP check's engine loop adds its steps to the same
        # histogram
        step = telemetry.metrics.get("serving_engine_step_seconds")
        step_count, step_seconds = step.count(), step.sum()
        spans = len(telemetry.tracer.log.spans())
        results = {r["key"]: r["result"]["tokens"] for r in gateway.reqlog.replay()
                   if r["kind"] == reqlog.COMPLETED}

        alone_engine = _serving_engine(model, params, draft, draft_params)
        decode_bench.drive(alone_engine, [warm], 1)
        alone_start = time.monotonic()
        alone = [decode_bench.drive(alone_engine, [p], SERVE_NEW_TOKENS)[0] for p in prompts]
        alone_s = time.monotonic() - alone_start
        diverging = [i for i, (a, b) in enumerate(zip(served, alone)) if a != b]
        if diverging:
            i = diverging[0]
            at = next(j for j, (a, b) in enumerate(zip(served[i], alone[i])) if a != b)
            raise AssertionError(
                f"drill request {i} (prompt {prompts[i].size} tokens) diverges from the engine "
                f"alone at token {at}: {served[i][at]} against {alone[i][at]}; "
                f"{len(diverging)} of {SERVE_REQUESTS} requests differ")

        # before check_http and check_recover add spans and engine steps
        analyzers = check_analyzers(workdir, telemetry.tracer, sorted(results),
                                    engine.prefill_tokens - prefill_before)
        http = check_http(gateway, prompts, alone)
        recovered = check_recover(workdir, engine, results)
        cli_drill = run_cli_drill(workdir / "cli")
    spec = report["engine"]["spec"]
    out = {
        "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW_TOKENS,
        "prompts": [list(p) for p in SERVE_PROMPTS], "shared_prefix": SERVE_PREFIX,
        "drill_seconds": drill_s, "tokens_generated": report["tokens_generated"],
        "tokens_per_sec": report["tokens_generated"] / drill_s,
        "p50_latency_s": report["p50_latency_s"], "p99_latency_s": report["p99_latency_s"],
        "ttft_p50_s": _percentile(ttft, 0.5), "ttft_p99_s": _percentile(ttft, 0.99),
        "engine_step_count": step_count, "engine_step_mean_s": step_seconds / step_count,
        "spans": spans, "k3_launches": launched, "spec": spec,
        "prefix": report["engine"]["prefix"],
        "distinct_tokens": len({t for toks in served for t in toks}),
        "engine_alone_seconds": alone_s, "token_identical": True,
        "http": http, "recover": recovered, "cli_drill": cli_drill, "analyzers": analyzers,
        "phase_seconds": time.monotonic() - started,
    }
    print("serving plane: " + json.dumps(out, sort_keys=True, default=str), flush=True)
    print(f"serving plane (phase 29): gateway over the LM 12L/768/vocab 32768 SlotEngine, int8 "
          f"cache, {SERVE_SLOTS} slots, drafter k={SERVE_SPEC_K} (acceptance "
          f"{spec['acceptance_rate']}), journal and spans fsync'd; drill of {SERVE_REQUESTS} x "
          f"{SERVE_NEW_TOKENS} tokens: p50 {out['p50_latency_s']:.4f} s, p99 "
          f"{out['p99_latency_s']:.4f} s, {out['tokens_per_sec']:.1f} tokens/s, TTFT p50 "
          f"{out['ttft_p50_s']:.4f} s p99 {out['ttft_p99_s']:.4f} s; engine step histogram "
          f"{out['engine_step_count']} steps, mean {out['engine_step_mean_s'] * 1e3:.3f} ms; "
          f"{spans} spans; K3 {launched} launches; token-identical to the engine alone "
          f"({out['distinct_tokens']} distinct tokens); HTTP plain = streamed = alone; "
          f"recover replays; CLI drill {cli_drill['completed']}/{cli_drill['submitted']}; "
          f"{out['phase_seconds']:.1f} s; on {card}", flush=True)
    return out


FLEET_REQUESTS = 24
FLEET_FIRST_WAVE = 8  # completed before the kill is armed
FLEET_DUPLICATES = 4
FLEET_SEED = 30
FLEET_REVIVE_AFTER_S = 3.0
FLEET_VICTIM = "g1"


class _WallClock:
    """`drive_fleet`'s clock over wall time: seconds since the phase began,
    `time.sleep` to wait. The drive loop alone reads `time()`, once a pass
    (the fleet, its gateways and journals read `now()`), so the longest
    stretch between two reads that no sleep began is the longest pass:
    the most a fleet tick can wait behind the engines' steps."""

    def __init__(self):
        self.start = time.monotonic()
        self.last = 0.0
        self.longest_pass_s = 0.0

    def now(self) -> float:
        return time.monotonic() - self.start

    def time(self) -> float:
        now = self.now()
        self.longest_pass_s = max(self.longest_pass_s, now - self.last)
        self.last = now
        return now

    def sleep(self, seconds: float) -> None:
        time.sleep(max(0.0, seconds))
        self.last = self.now()


class _KillWhenBusy:
    """A world event for `drive_fleet`: kills `rid` at the first step
    boundary at which it holds an in-flight slot and a queued key. Its `at`
    is the past while that holds and never otherwise, so the drive fires it
    between two passes of its engines and waits for it before it ends."""

    def __init__(self, fleet, rid: str):
        self.fleet, self.rid = fleet, rid
        self.killed_at: float | None = None
        self.inflight = self.queued = 0

    @property
    def at(self) -> float:
        gateway = self.fleet.gateways[self.rid]
        busy = (self.fleet.alive[self.rid] and gateway.queue_depth() > 0
                and any(w.inflight for w in gateway.workers.values()))
        return -math.inf if busy else math.inf

    def fn(self, fleet) -> None:
        gateway = fleet.gateways[self.rid]
        self.inflight = sum(len(w.inflight) for w in gateway.workers.values())
        self.queued = gateway.queue_depth()
        self.killed_at = fleet.clock()
        fleet.kill(self.rid)


def _fleet_prompts() -> list:
    """24 prompts of 64-256 tokens from seed 30, sharing no prefix: a
    re-admitted prompt prefills from position 0 on a reset engine, as it
    does on a fresh one, so each has one right answer wherever it is
    served."""
    rng = np.random.default_rng(FLEET_SEED)
    return [rng.integers(0, 32768, int(n)).astype(np.int32)
            for n in rng.integers(64, 257, FLEET_REQUESTS)]


def drive_gateway_fleet(model, params, draft, draft_params, workdir: pathlib.Path) -> dict:
    """The gateway fleet (`serving/fleet.GatewayFleet`, 2 replicas, the
    reference's other defaults) over two `SlotEngine`s that share the
    model's weights, each with its own KV pool, its slice leases on the
    fsync'd event ledger at `RunPaths(workdir).events`, its journal
    shards fsync'd, driven by `drive_fleet` on a wall clock: a first wave
    of 8 keyed greedy requests; a second of 16, during which g1 is killed
    at the first step boundary at which it holds an in-flight slot and a
    queued key; then, a few seconds after the kill, g1 revived as a
    standby while 4 duplicates of first-wave keys (g1's first) are
    resubmitted. Raises unless every key settled once, `check_fleet`
    finds nothing, the successor re-admitted a key, the duplicates came
    from the journal with no engine step, the tokens equal the engine
    alone's, g1's slices were revoked and granted again at higher epochs,
    the reassignment came within one tick and one drive pass of the kill,
    and `cli.main status --json --all` reads the lease counts back."""
    started = time.monotonic()
    paths = RunPaths(workdir)
    engines = {i: _serving_engine(model, params, draft, draft_params, slice_index=i)
               for i in range(2)}
    clock = _WallClock()
    ledger = events.EventLedger(paths.events, clock=clock.now, echo=lambda line: None)
    gw_policy = _serving_policy()
    fleet = fleet_mod.GatewayFleet(
        engines, paths, ledger, policy=fleet_mod.FleetPolicy(replicas=2),
        gateway_policy=gw_policy, clock=clock.now,
        echo=lambda line: print(f"phase 30: {line}", flush=True))
    prompts = _fleet_prompts()
    keys = [f"fleet-{i}" for i in range(FLEET_REQUESTS)]

    def wave(indices, at: float) -> list:
        return [Request(rid=i, prompt_len=int(prompts[i].size),
                        max_new_tokens=SERVE_NEW_TOKENS, tokens=prompts[i], key=keys[i],
                        arrival=at) for i in indices]

    da.decode_attention_kernel.launches = 0
    first = fleet_mod.drive_fleet(fleet, wave(range(FLEET_FIRST_WAVE), clock.now()), clock,
                                  horizon_s=clock.now() + 1.0)
    kill = _KillWhenBusy(fleet, FLEET_VICTIM)
    second = fleet_mod.drive_fleet(fleet, wave(range(FLEET_FIRST_WAVE, FLEET_REQUESTS),
                                                   clock.now()),
                                   clock, horizon_s=clock.now() + 1.0, events=(kill,))
    drive_s = clock.now()
    if kill.killed_at is None or not (first["quiescent"] and second["quiescent"]):
        raise AssertionError(f"fleet: kill at {kill.killed_at}, quiescent "
                             f"{first['quiescent']} / {second['quiescent']}")
    # read before the revival replaces g1's gateway and its metrics
    completed_requests = [r for gw in fleet.gateways.values() for r in gw.metrics.completed]
    steps_before = sum(e.steps for e in engines.values())
    launches_before = da.decode_attention_kernel.launches

    # the duplicates: first-wave keys, those g1's partitions held first
    owned_by_victim = [k for k in keys[:FLEET_FIRST_WAVE]
                       if fleet_mod.partition_of(f"key:{k}", fleet.policy.partitions) % 2 == 1]
    duplicates = (owned_by_victim + [k for k in keys[:FLEET_FIRST_WAVE]
                                     if k not in owned_by_victim])[:FLEET_DUPLICATES]
    admissions: dict = {}

    def resubmit(fleet) -> None:
        for n, key in enumerate(duplicates):
            i = keys.index(key)
            admissions[key] = fleet.submit(Request(
                rid=1000 + n, prompt_len=int(prompts[i].size),
                max_new_tokens=SERVE_NEW_TOKENS, tokens=prompts[i], key=key))

    third = fleet_mod.drive_fleet(
        fleet, [], clock, horizon_s=clock.now() + FLEET_REVIVE_AFTER_S + 1.0,
        events=(traffic.WorldEvent(clock.now(), resubmit),
                traffic.WorldEvent(kill.killed_at + FLEET_REVIVE_AFTER_S,
                                   lambda fleet: fleet.revive(FLEET_VICTIM))))
    duplicate_steps = sum(e.steps for e in engines.values()) - steps_before
    duplicate_launches = da.decode_attention_kernel.launches - launches_before
    launches = da.decode_attention_kernel.launches

    journals = [fleet.reqlogs[rid].replay() for rid in fleet.replica_ids]
    merged = reqlog.merge_records(*journals)
    led = ledger.replay()
    violations = chaos.ServeInvariantChecker(gw_policy).check_fleet(journals, led)
    terminal = {}
    for r in merged:
        if r["kind"] in (reqlog.COMPLETED, reqlog.EXPIRED):
            terminal.setdefault(r["key"], []).append(r)
    served = {k: rs[0]["result"]["tokens"] for k, rs in terminal.items()
              if len(rs) == 1 and rs[0]["kind"] == reqlog.COMPLETED}
    audit = fleet.reassignments[0] if fleet.reassignments else {}

    alone_engine = _serving_engine(model, params, draft, draft_params)
    alone_start = time.monotonic()
    alone = dict(zip(keys, decode_bench.drive(alone_engine, prompts, SERVE_NEW_TOKENS)))
    alone_s = time.monotonic() - alone_start
    diverging = [k for k in keys if served.get(k) != alone[k]]

    revoked = [r for r in led if r["kind"] == events.LEASE_REVOKE
               and r["replica"] == FLEET_VICTIM]
    regranted = [any(g["kind"] == events.LEASE_GRANT and g["slice"] == r["slice"]
                     and g["epoch"] > r["epoch"] and g["ts"] >= r["ts"] for g in led)
                 for r in revoked]
    status = subprocess.run(
        [sys.executable, "-m", "tritonk8ssupervisor_tpu_torch.cli.main", "status", "--json",
         "--all", "--workdir", str(workdir)],
        cwd=pathlib.Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=120)
    block = json.loads(status.stdout).get("gateway_fleet", {}) if status.returncode == 0 else {}
    counts = {kind: sum(1 for r in led if r["kind"] == kind)
              for kind in (events.LEASE_GRANT, events.LEASE_REVOKE)}
    ttft = [r.first_token_at - r.arrival for r in completed_requests]
    latency = [r.done_at - r.arrival for r in completed_requests]
    tokens = sum(len(t) for t in served.values())
    out = {
        "requests": FLEET_REQUESTS, "first_wave": FLEET_FIRST_WAVE,
        "new_tokens": SERVE_NEW_TOKENS, "prompt_tokens": [int(p.size) for p in prompts],
        "replicas": fleet.replica_ids, "slices": sorted(engines),
        "drive_seconds": drive_s, "tokens_generated": tokens, "tokens_per_sec": tokens / drive_s,
        "p50_latency_s": _percentile(latency, 0.5), "p99_latency_s": _percentile(latency, 0.99),
        "ttft_p50_s": _percentile(ttft, 0.5), "ttft_p99_s": _percentile(ttft, 0.99),
        "killed": FLEET_VICTIM, "kill_at_s": kill.killed_at,
        "inflight_at_kill": kill.inflight, "queued_at_kill": kill.queued,
        "reassignment": audit, "keys_redone": audit.get("redone", 0),
        "kill_to_reassign_s": audit["at"] - kill.killed_at if audit else None,
        "tick_every_s": fleet.policy.tick_every_s, "longest_pass_s": clock.longest_pass_s,
        "duplicates": {k: admissions[k].reason for k in duplicates},
        "duplicate_engine_steps": duplicate_steps, "duplicate_k3_launches": duplicate_launches,
        "third_drive_quiescent": third["quiescent"], "alive_at_end": fleet.live_replicas(),
        "lease_records": {kind: sum(1 for r in led if r["kind"] == kind) for kind in
                          (events.LEASE_GRANT, events.LEASE_RENEW, events.LEASE_EXPIRE,
                           events.LEASE_REVOKE)},
        "revoked_slices": [r["slice"] for r in revoked],
        "status_rc": status.returncode,
        "status_gateway_fleet": {k: block.get(k) for k in ("grants", "revokes", "lease_epoch",
                                                          "replicas", "leases_total")},
        "violations": violations, "k3_launches": launches,
        "distinct_tokens": len({t for toks in served.values() for t in toks}),
        "engine_alone_seconds": alone_s, "token_identical": not diverging,
    }
    problems = []
    if violations:
        problems.append(f"check_fleet: {violations[:5]}")
    if (sorted(served) != sorted(keys) or any(len(rs) != 1 for rs in terminal.values())
            or len(completed_requests) != FLEET_REQUESTS):
        problems.append(f"settled {sorted(terminal)} with "
                        f"{ {k: len(rs) for k, rs in terminal.items() if len(rs) != 1} }")
    if not audit or audit["redone"] < 1 or audit["from"] != FLEET_VICTIM:
        problems.append(f"no key re-admitted by the successor's adoption: {audit}")
    if any(a.reason != gateway_mod.REPLAYED or a.result["tokens"] != served[k]
           for k, a in admissions.items()) or duplicate_steps or duplicate_launches:
        problems.append(f"duplicates {out['duplicates']}, {duplicate_steps} engine steps, "
                        f"{duplicate_launches} K3 launches")
    if diverging:
        k = diverging[0]
        at = next((j for j, (a, b) in enumerate(zip(served.get(k, []), alone[k])) if a != b),
                  None)
        problems.append(f"{len(diverging)} of {FLEET_REQUESTS} keys differ from the engine "
                        f"alone, first {k} at token {at}")
    if not revoked or not all(regranted):
        problems.append(f"{FLEET_VICTIM}'s slices revoked {out['revoked_slices']}, granted "
                        f"again at a higher epoch {regranted}")
    if audit and out["kill_to_reassign_s"] > fleet.policy.tick_every_s + clock.longest_pass_s:
        problems.append(f"kill to reassignment {out['kill_to_reassign_s']:.3f} s, past one "
                        f"tick and one pass")
    if (status.returncode != 0 or block.get("grants") != counts[events.LEASE_GRANT]
            or block.get("revokes") != counts[events.LEASE_REVOKE]):
        problems.append(f"status --json --all: rc {status.returncode}, block {block}, "
                        f"ledger {counts}, stderr {status.stderr[-2000:]}")
    if not third["quiescent"] or fleet.live_replicas() != fleet.replica_ids:
        problems.append(f"revive: quiescent {third['quiescent']}, alive "
                        f"{fleet.live_replicas()}")
    out["fleet_demand"] = demand = read_fleet_demand(paths)
    if demand["replicas"] != fleet.replica_ids or not demand["equal_to_merge"] or \
            demand["merged_queue_depth"] != demand["published_queue_depth"] or \
            demand["merged_service_rate"] != demand["published_service_rate"]:
        problems.append(f"read_fleet_demand: {demand}")
    if problems:
        raise AssertionError("gateway fleet: " + "; ".join(problems))
    out["phase_seconds"] = time.monotonic() - started
    return out


def read_fleet_demand(paths: RunPaths) -> dict:
    """The port's `autoscale.read_fleet_demand` over the fleet's workdir:
    the replicas whose shards it found, whether its signal equals the merge
    of each shard read alone, and its queue depth and service rate beside
    the sums of what the replicas published (their shards as written)."""
    shards = autoscale.fleet_signal_paths(paths.demand_signal)
    published = {r: json.loads(p.read_text()) for r, p in shards.items()}
    merged = autoscale.read_fleet_demand(paths.demand_signal)
    alone = autoscale.merge_demand_signals(
        {r: autoscale.read_demand_signal(p) for r, p in shards.items()},
        max_age=autoscale.FLEET_SIGNAL_MAX_AGE_S)
    rates = [doc["service_rate"] for doc in published.values()
             if doc.get("service_rate") is not None]
    return {
        "replicas": sorted(shards), "equal_to_merge": merged is not None and merged == alone,
        "merged_queue_depth": None if merged is None else merged.queue_depth,
        "published_queue_depth": sum(doc["queue_depth"] for doc in published.values()),
        "merged_service_rate": None if merged is None else merged.service_rate,
        "published_service_rate": sum(rates) if rates else None,
        "published": {r: {k: doc.get(k) for k in ("queue_depth", "service_rate", "updated")}
                      for r, doc in published.items()},
    }


def run_gateway_fleet(card: str) -> dict:
    """Phase 30: the gateway fleet over two full-width int8-cache engines
    with drafters (`drive_gateway_fleet`), K3 counted around it."""
    started = time.monotonic()
    model, params, draft, draft_params = _serving_models()
    with tempfile.TemporaryDirectory() as tmp:
        out = drive_gateway_fleet(model, params, draft, draft_params, pathlib.Path(tmp))
    if out["k3_launches"] == 0:
        raise AssertionError("gateway fleet: K3 launched no time")
    out["phase_seconds"] = time.monotonic() - started
    print("gateway fleet: " + json.dumps(out, sort_keys=True, default=str), flush=True)
    print(f"gateway fleet (phase 30): 2 replicas over 2 LM 12L/768/vocab 32768 SlotEngines "
          f"(int8 cache, {SERVE_SLOTS} slots, drafter k={SERVE_SPEC_K}), leases and journals "
          f"fsync'd; {FLEET_REQUESTS} x {SERVE_NEW_TOKENS} tokens: p50 "
          f"{out['p50_latency_s']:.4f} s, p99 {out['p99_latency_s']:.4f} s, TTFT p50 "
          f"{out['ttft_p50_s']:.4f} s p99 {out['ttft_p99_s']:.4f} s, "
          f"{out['tokens_per_sec']:.1f} tokens/s; {FLEET_VICTIM} killed with "
          f"{out['inflight_at_kill']} in flight and {out['queued_at_kill']} queued, "
          f"reassigned {out['kill_to_reassign_s']:.3f} s after the kill (a tick every "
          f"{out['tick_every_s']} s), {out['keys_redone']} keys redone; "
          f"{FLEET_DUPLICATES} duplicates replayed; token-identical to the engine alone "
          f"({out['distinct_tokens']} distinct tokens); K3 {out['k3_launches']} launches; "
          f"read_fleet_demand merged {out['fleet_demand']['replicas']}: queue depth "
          f"{out['fleet_demand']['merged_queue_depth']}, service rate "
          f"{out['fleet_demand']['merged_service_rate']}, the sums of the shards; "
          f"{out['phase_seconds']:.1f} s; on {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 31: a maintenance drain of the full-width LM

DRAIN_STEPS = 20  # steps a window: ~1 s at the LM's step, 20 watch intervals
DRAIN_WINDOWS = 3  # the drain lands after window 1 or 2: one or more are left
DRAIN_INTERVAL_S = 0.05
DRAIN_EVENT = "TERMINATE_ON_HOST_MAINTENANCE"
DRAIN_RUN_TIMEOUT_S = 300
LM_MODULE = "tritonk8ssupervisor_tpu_torch.benchmarks.lm"
# `python -m LM_MODULE ARGS` as runpy runs it, writing K1's and K2's launch
# counts (each direction) and the seconds of each checkpoint save to
# $TK8S_SMOKE_COUNTS at exit: the counters of the run's own process
LM_CHILD = f"""
import atexit, json, os, runpy, sys, time
from tritonk8ssupervisor_tpu_torch.ops import cross_entropy as ce, flash_attention as fa
from tritonk8ssupervisor_tpu_torch.parallel import checkpoint as ckpt_lib
saves, save = [], ckpt_lib.TrainCheckpointer.save
def timed_save(self, step, state):
    start = time.monotonic()
    save(self, step, state)
    saves.append(time.monotonic() - start)
def report():
    with open(os.environ["TK8S_SMOKE_COUNTS"], "w") as f:
        json.dump({{"k1": ce.cross_entropy_forward.launches,
                   "k1_backward": ce.cross_entropy_backward.launches,
                   "k2_forward": fa.flash_attention_forward.launches,
                   "k2_backward": fa.flash_attention_backward.launches,
                   "save_seconds": saves}}, f)
ckpt_lib.TrainCheckpointer.save = timed_save
atexit.register(report)
runpy.run_module("{LM_MODULE}", run_name="__main__", alter_sys=True)
"""
# `python -m ...provision.maintenance --once` with its metadata fetch sent to
# a closed port on this host, which it reads as an unreachable server: the
# card machine must not try to reach an outside host
MAINTENANCE_CLI = """
import sys
from tritonk8ssupervisor_tpu_torch.provision import maintenance
fetch, url = maintenance._default_fetch, sys.argv.pop(1)
maintenance._default_fetch = lambda _, timeout: fetch(url, timeout)
sys.exit(maintenance.main(sys.argv[1:]))
"""


class _ScriptedMetadata:
    """The metadata server's maintenance-event key for `maintenance.watch`:
    "NONE" until the drained run's checkpoint directory holds a committed
    step, then the event until `exited` is set, then "NONE" again."""

    def __init__(self, checkpoint_dir: pathlib.Path):
        self.markers = checkpoint_dir / ckpt_lib.COMMIT_DIR
        self.exited = threading.Event()
        self.event_at: float | None = None

    def __call__(self, url: str, timeout: float) -> str:
        if self.exited.is_set():
            return "NONE"
        if self.event_at is None:
            if not (self.markers.is_dir() and any(self.markers.iterdir())):
                return "NONE"
            self.event_at = time.monotonic()
        return DRAIN_EVENT


class _StopWatch(Exception):
    """Raised by the watchdog's sleep once the phase is done with it."""


def _start_watchdog(drain_file: pathlib.Path, fetch, log: list):
    """`maintenance.watch` in a thread: (thread, stop event, the errors it
    raised). Setting the event ends it at its next sleep."""
    stop, errors = threading.Event(), []

    def sleep(seconds: float) -> None:
        if stop.wait(seconds):
            raise _StopWatch

    def run() -> None:
        try:
            maintenance.watch(drain_file, interval=DRAIN_INTERVAL_S, fetch=fetch, sleep=sleep,
                              log=log.append)
        except _StopWatch:
            pass
        except BaseException as e:  # noqa: BLE001 - re-raised by the phase
            errors.append(e)

    thread = threading.Thread(target=run, name="maintenance-watch", daemon=True)
    thread.start()
    return thread, stop, errors


def _lm_run(args: list[str], drain_file: pathlib.Path, counts_file: pathlib.Path
            ) -> tuple[dict, dict, float]:
    """One LM benchmark process at its defaults with `args`: (its JSON
    report, its counters, the monotonic time it exited)."""
    env = {**os.environ, maintenance.DRAIN_FILE_VAR: str(drain_file),
           "TK8S_SMOKE_COUNTS": str(counts_file)}
    out = subprocess.run([sys.executable, "-c", LM_CHILD, *args, "--json"], env=env,
                         capture_output=True, text=True, timeout=DRAIN_RUN_TIMEOUT_S,
                         cwd=pathlib.Path(__file__).resolve().parent)
    exited = time.monotonic()
    if out.returncode:
        raise AssertionError(f"LM run {args} exited {out.returncode}: {out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1]), json.loads(counts_file.read_text()), \
        exited


def _restored_lm(directory: pathlib.Path) -> train.TrainState:
    """The LM benchmark's default model and optimizer state, restored from
    the latest committed step in `directory`."""
    model = TransformerLM(vocab_size=32768, num_layers=12, num_heads=12, embed_dim=768,
                          max_seq_len=1024)
    state = train.create_train_state(model, train.default_optimizer())
    return ckpt_lib.TrainCheckpointer(directory).restore(state)


def run_maintenance_drain(card: str) -> dict:
    """Phase 31: the LM benchmark at its defaults drained by the port's
    maintenance watchdog (`provision/maintenance.watch` in a thread, its
    metadata fetch scripted) at a window boundary after its first committed
    step; the watchdog removes the drain file when the event clears; the
    same command resumes from the drained run's last step; a straight run
    to the same step must restore bit-equal, parameters and momentum. Then
    the watchdog's CLI polls once against an unreachable server."""
    started = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        drained_dir, straight_dir = root / "drained", root / "straight"
        drain_file = root / "tk8s-drain"
        metadata = _ScriptedMetadata(drained_dir)
        log: list = []
        watchdog, stop, errors = _start_watchdog(drain_file, metadata, log)
        args = ["--steps", str(DRAIN_STEPS), "--warmup", "1", "--windows", str(DRAIN_WINDOWS),
                "--checkpoint-dir", str(drained_dir)]
        drained, drained_counts, exited = _lm_run(args, drain_file, root / "counts-drained.json")
        metadata.exited.set()
        if metadata.event_at is None:
            raise AssertionError("the drained run exited before its first committed step")
        drain_latency = exited - metadata.event_at
        deadline = time.monotonic() + 5.0
        while drain_file.exists() and time.monotonic() < deadline:
            time.sleep(DRAIN_INTERVAL_S)
        cleared = not drain_file.exists()
        marker = drained_dir / ckpt_lib.COMMIT_DIR / str(drained["final_step"])
        reason = f"maintenance-event: {DRAIN_EVENT}"
        if (drained["drained"] is None or reason not in drained["drained"]
                or drained["windows"] >= DRAIN_WINDOWS or not marker.exists() or not cleared):
            raise AssertionError(
                f"drained run: drained {drained['drained']!r}, {drained['windows']} of "
                f"{DRAIN_WINDOWS} windows, step {drained['final_step']} committed "
                f"{marker.exists()}, drain file removed {cleared}; watchdog log {log}")
        resumed, resumed_counts, _ = _lm_run(args, drain_file, root / "counts-resumed.json")
        stop.set()
        watchdog.join(timeout=10)
        if errors or watchdog.is_alive():
            raise AssertionError(f"the watchdog failed: {errors!r}, alive {watchdog.is_alive()}")
        if resumed["start_step"] != drained["final_step"] or resumed["drained"] is not None:
            raise AssertionError(f"resumed run: start_step {resumed['start_step']} after the "
                                 f"drained run's {drained['final_step']}, drained "
                                 f"{resumed['drained']!r}")
        # one step under the FLOP counter, `warmup` more, then windows x steps:
        # the straight run's windows and warm-up come out of the two reports,
        # its windows run as one (one checkpoint save, the same steps)
        target = resumed["final_step"]
        windows = (target - 2) // DRAIN_STEPS
        warmup = target - 1 - windows * DRAIN_STEPS
        straight, straight_counts, _ = _lm_run(
            ["--steps", str(windows * DRAIN_STEPS), "--warmup", str(warmup), "--windows", "1",
             "--checkpoint-dir", str(straight_dir)],
            root / "never-drained", root / "counts-straight.json")
        if straight["final_step"] != target or straight["drained"] is not None:
            raise AssertionError(f"straight run ended at {straight['final_step']}, drained "
                                 f"{straight['drained']!r}; the resumed run at {target}")
        a, b = _restored_lm(straight_dir), _restored_lm(drained_dir)
        diffs = [(x - y).abs().max().item()
                 for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values())]
        diffs += [(a.optimizer.state[p]["momentum_buffer"]
                   - b.optimizer.state[q]["momentum_buffer"]).abs().max().item()
                  for p, q in zip(a.model.parameters(), b.model.parameters())]
        steps = (a.step, b.step)
        del a, b
        torch.cuda.empty_cache()
        closed = socket.socket()
        closed.bind(("127.0.0.1", 0))
        url = (f"http://127.0.0.1:{closed.getsockname()[1]}/computeMetadata/v1/instance/"
               "maintenance-event")
        closed.close()
        cli_file = root / "cli-drain"
        cli_run = subprocess.run(
            [sys.executable, "-c", MAINTENANCE_CLI, url, "--once", "--drain-file", str(cli_file)],
            capture_output=True, text=True, timeout=60,
            cwd=pathlib.Path(__file__).resolve().parent)
        if cli_run.returncode != 0 or cli_file.exists():
            raise AssertionError(f"maintenance --once exited {cli_run.returncode}, wrote the "
                                 f"drain file {cli_file.exists()}: {cli_run.stderr[-2000:]}")
    counts = {k: sum(c[k] for c in (drained_counts, resumed_counts, straight_counts))
              for k in ("k1", "k1_backward", "k2_forward", "k2_backward")}
    if (steps != (target, target) or max(diffs) != 0.0 or 0 in counts.values()
            or counts["k1_backward"] != counts["k1"]):
        raise AssertionError(f"straight against drained + resumed: steps {steps}, max |diff| "
                             f"{max(diffs)}, launches {counts}")
    saves = drained_counts["save_seconds"] + resumed_counts["save_seconds"] + \
        straight_counts["save_seconds"]
    out = {
        "steps_per_window": DRAIN_STEPS, "windows": DRAIN_WINDOWS,
        "windows_before_drain": drained["windows"], "drained": drained["drained"],
        "drained_final_step": drained["final_step"], "resumed_start_step": resumed["start_step"],
        "final_step": target, "straight_windows": windows, "straight_warmup": warmup,
        "drain_latency_s": drain_latency, "watchdog_log": log,
        "save_seconds": saves, "save_seconds_mean": statistics.mean(saves),
        "restore_seconds": resumed["restore_seconds"],
        "step_ms": {"drained": drained["step_ms"], "resumed": resumed["step_ms"],
                    "straight": straight["step_ms"]},
        "step_ms_windows": {"drained": drained["step_ms_windows"],
                            "resumed": resumed["step_ms_windows"],
                            "straight": straight["step_ms_windows"]},
        "max_abs_diff": max(diffs), "launches": counts,
        "launches_by_run": {"drained": drained_counts, "resumed": resumed_counts,
                            "straight": straight_counts},
        "cli_once_rc": cli_run.returncode,
        "phase_seconds": time.monotonic() - started,
    }
    print("maintenance drain: " + json.dumps(out, sort_keys=True), flush=True)
    print(f"maintenance drain (phase 31): LM 12L/768/seq 1024/batch 8, {DRAIN_STEPS} steps a "
          f"window; drained after {drained['windows']} of {DRAIN_WINDOWS} windows at step "
          f"{drained['final_step']}, {drain_latency:.3f} s from the event to the run's exit; "
          f"the watchdog removed the drain file; resumed {resumed['start_step']} -> {target}, "
          f"bit-equal to a straight run (max |diff| {max(diffs)}); checkpoint save "
          f"{statistics.mean(saves):.3f} s mean over {len(saves)}, restore "
          f"{resumed['restore_seconds']:.3f} s; step ms drained {drained['step_ms']:.2f}, resumed "
          f"{resumed['step_ms']:.2f}, straight {straight['step_ms']:.2f}; K1 {counts['k1']} + "
          f"{counts['k1_backward']}, K2 "
          f"{counts['k2_forward']} + {counts['k2_backward']} launches; maintenance --once exit "
          f"0, no drain file; {out['phase_seconds']:.1f} s; on {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 32: the compiled benchmark Jobs' workloads from the installed archive

# the Jobs' benchmark flags: the workload cut to a few windows, at full width
SHIPPED_FLAGS = {
    "lm": ("--steps", "10", "--warmup", "1", "--windows", "2"),
    "resnet50": ("--fused-1x1-bwd", "--steps", "5", "--warmup", "2", "--windows", "2"),
}
# what each workload builds besides K1
SHIPPED_KERNEL = {"lm": K2_SOURCE, "resnet50": K4_SOURCE}
SHIPPED_SOURCES = ["conv_backward.cu", "conv_backward_tf32.cu", "cross_entropy.cu",
                   "decode_attention.cu", "flash_attention.cu", "flash_attention_tf32.cu",
                   "hopper.cuh"]
SHIPPED_RUN_TIMEOUT_S = 600
CONFIGMAP_LIMIT_BYTES = 1_048_576  # the API server's limit on one object
# `python -m MODULE ARGS` of the installed package as runpy runs it, writing
# the package it imported, the seconds of each nvcc build, the built
# libraries' paths and K1's (each direction), K2's and K4's launch counts to
# $TK8S_SMOKE_COUNTS at exit: the counters of the run's own process; and
# the wall-clock time its interpreter reached its first statement
SHIPPED_CHILD = """
import time
started_at = time.time()
import atexit, json, os, runpy, sys
import tritonk8ssupervisor_tpu_torch as package
from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb, cross_entropy as ce
from tritonk8ssupervisor_tpu_torch.ops import cuda_build, flash_attention as fa
builds, build = {}, cuda_build.build
def timed_build(source_name):
    start = time.monotonic()
    path = build(source_name)
    builds[source_name] = time.monotonic() - start
    return path
def report():
    with open(os.environ["TK8S_SMOKE_COUNTS"], "w") as f:
        json.dump({"package": package.__file__, "build_seconds": builds,
                   "started_at": started_at,
                   "libraries": {s: str(cuda_build.library_path(s))
                                 for s in ("cross_entropy.cu", "flash_attention.cu",
                                           "conv_backward.cu")},
                   "k1": ce.cross_entropy_forward.launches,
                   "k1_backward": ce.cross_entropy_backward.launches,
                   "k2_forward": fa.flash_attention_forward.launches,
                   "k2_backward": fa.flash_attention_backward.launches,
                   "k4": cb.conv1x1_backward_kernel.launches}, f)
cuda_build.build = timed_build
atexit.register(report)
runpy.run_module(sys.argv.pop(1), run_name="__main__", alter_sys=True)
"""


def _compiled_job(root: pathlib.Path, workload: str) -> tuple[dict, dict, int]:
    """The port's compiler on a one-host GKE config: the Job set of
    `workload`, read back from the YAML it wrote: (the ConfigMap, the
    slice's Job, the ConfigMap document's bytes)."""
    config = ClusterConfig(project="p", zone="us-west4-a", generation="v5e", topology="2x2",
                           mode="gke")
    out_dir = root / "manifests" / workload
    extra = {"checkpoint_dir": str(root / "ckpt")} if workload == "lm" else {}
    names = [p.name for p in compiler.write_manifests(
        config, out_dir, workload=workload, bench_flags=SHIPPED_FLAGS[workload], **extra)]
    if names != ["package-configmap.yaml", "bench-service.yaml", "bench-job-0.yaml"]:
        raise AssertionError(f"{workload} Job set: {names}")
    text = (out_dir / "package-configmap.yaml").read_text()
    return (yaml.safe_load(text), yaml.safe_load((out_dir / "bench-job-0.yaml").read_text()),
            len(text.encode()))


def _job_workload(job: dict) -> tuple[list[str], dict]:
    """The Job's container command after its `pip install ... &&` (the
    workload's argv) and its env, each fieldRef read as pod 0."""
    container = job["spec"]["template"]["spec"]["containers"][0]
    shell, flag, script = container["command"]
    install, workload = script.split("&&")
    archive = f"{compiler.PACKAGE_MOUNT_PATH}/{packaging.ARCHIVE_NAME}"
    if (shell, flag) != ("bash", "-c") or not install.strip().startswith(
            f"pip install --quiet {archive} "):
        raise AssertionError(f"the Job's command installs no archive: {container['command']}")
    env = {e["name"]: e["value"] if "value" in e else "0" for e in container["env"]}
    return shlex.split(workload), env


def _archive_members(blob: bytes) -> list[str]:
    with tarfile.open(fileobj=io.BytesIO(blob)) as tar:
        return tar.getnames()


def run_shipped_workload(card: str) -> dict:
    """Phase 32: the compiled LM and fused ResNet-50 Jobs' workloads at full
    width from the archive their ConfigMap carries, installed the Job's
    way, with K2 and K4 built by nvcc from the installed sources."""
    started = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        compiled = {w: _compiled_job(root, w) for w in SHIPPED_FLAGS}
        blobs = {w: base64.b64decode(cm["binaryData"][packaging.ARCHIVE_NAME])
                 for w, (cm, _, _) in compiled.items()}
        blob = blobs["lm"]
        members = _archive_members(blob)
        sources = sorted(n.rsplit("/", 1)[1] for n in members if "/csrc/" in n)
        configmap_bytes = max(size for _, _, size in compiled.values())
        if (blobs["resnet50"] != blob or blob != packaging.build_archive_bytes()
                or sources != SHIPPED_SOURCES or configmap_bytes >= CONFIGMAP_LIMIT_BYTES
                or any("/csrc/build" in n for n in members)):
            raise AssertionError(f"the ConfigMap's archive: CUDA sources {sources}, "
                                 f"{configmap_bytes} bytes of ConfigMap, members {members}")
        archive = root / packaging.ARCHIVE_NAME
        archive.write_bytes(blob)
        site = root / "site"
        install_started = time.monotonic()
        pip = subprocess.run(
            [sys.executable, "-m", "pip", "install", "--quiet", "--no-index",
             "--disable-pip-version-check", "--no-build-isolation",
             "--no-deps", "--target", str(site), str(archive)],
            capture_output=True, text=True, timeout=300)
        install_s = time.monotonic() - install_started
        toolchain = {name: importlib.metadata.version(name) for name in ("pip", "setuptools")}
        toolchain["wheel"] = importlib.util.find_spec("wheel") is not None
        csrc = site / "tritonk8ssupervisor_tpu_torch" / "csrc"
        installed = sorted(p.name for p in csrc.iterdir()) if csrc.is_dir() else []
        if pip.returncode or installed != SHIPPED_SOURCES:
            raise AssertionError(f"pip install exited {pip.returncode}, installed csrc "
                                 f"{installed}: {pip.stderr[-3000:]}")
        runs = {}
        for workload, (_, job, _) in compiled.items():
            argv, job_env = _job_workload(job)
            module = f"tritonk8ssupervisor_tpu_torch.benchmarks.{workload}"
            if argv[:3] != ["python", "-m", module] or "--json" not in argv:
                raise AssertionError(f"{workload} Job's workload: {argv}")
            counts_file = root / f"counts-{workload}.json"
            env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
            env.update(job_env, PYTHONPATH=str(site), TK8S_SMOKE_COUNTS=str(counts_file))
            run_started = time.monotonic()
            out = subprocess.run([sys.executable, "-c", SHIPPED_CHILD, *argv[2:]], cwd=root,
                                 env=env, capture_output=True, text=True,
                                 timeout=SHIPPED_RUN_TIMEOUT_S)
            if out.returncode:
                raise AssertionError(f"{workload} Job's workload exited {out.returncode}: "
                                     f"{out.stderr[-3000:]}")
            report = json.loads(out.stdout.strip().splitlines()[-1])
            counts = json.loads(counts_file.read_text())
            runs[workload] = {"argv": argv, "report": report, "counts": counts,
                              "seconds": time.monotonic() - run_started}
            libraries = [pathlib.Path(counts["libraries"][source])
                         for source in (K1_SOURCE, SHIPPED_KERNEL[workload])]
            steps = report["final_step"]
            launches = ((counts["k1"], counts["k1_backward"], counts["k2_forward"],
                         counts["k2_backward"]) if workload == "lm"
                        else (counts["k1"], counts["k1_backward"], counts["k4"]))
            layers = report.get("num_layers")
            expected = ((steps, steps, layers * steps, layers * steps) if workload == "lm"
                        else (steps, steps, sum(calls for *_, calls in K4_SHAPES) * steps))
            if (not counts["package"].startswith(str(site))
                    or any(lib.parent != csrc / "build" or not lib.is_file()
                           for lib in libraries)
                    or set(counts["build_seconds"]) != {K1_SOURCE, SHIPPED_KERNEL[workload]}
                    or launches != expected
                    or report["platform"] != "gpu" or not math.isfinite(report["final_loss"])):
                raise AssertionError(f"{workload} Job's workload: package {counts['package']}, "
                                     f"libraries {libraries} (exist "
                                     f"{[lib.is_file() for lib in libraries]}), builds "
                                     f"{counts['build_seconds']}, "
                                     f"launches {launches} against {expected}, report {report}")
        markers = root / "ckpt" / ckpt_lib.COMMIT_DIR
        committed = sorted(p.name for p in markers.iterdir()) if markers.is_dir() else []
        if str(runs["lm"]["report"]["final_step"]) not in committed:
            raise AssertionError(f"the LM Job left committed steps {committed}, its last step "
                                 f"{runs['lm']['report']['final_step']}")
    lm, resnet = runs["lm"], runs["resnet50"]
    out = {
        "archive_bytes": len(blob), "archive_members": len(members),
        "configmap_bytes": configmap_bytes, "install_seconds": install_s,
        "install_toolchain": toolchain,
        # K1 is built by the LM Job, the first to run; the ResNet-50 Job loads it
        "build_seconds": {**resnet["counts"]["build_seconds"],
                          **lm["counts"]["build_seconds"]},
        "lm": {"argv": lm["argv"], "step_ms": lm["report"]["step_ms"],
               "tokens_per_sec": lm["report"]["tokens_per_sec"],
               "final_step": lm["report"]["final_step"], "committed_steps": committed,
               "run_seconds": lm["seconds"],
               "launches": {k: lm["counts"][k]
                            for k in ("k1", "k1_backward", "k2_forward", "k2_backward")}},
        "resnet50": {"argv": resnet["argv"], "step_ms": resnet["report"]["step_ms"],
                     "images_per_sec": resnet["report"]["images_per_sec"],
                     "global_batch": resnet["report"]["global_batch"],
                     "final_step": resnet["report"]["final_step"],
                     "run_seconds": resnet["seconds"],
                     "launches": {k: resnet["counts"][k] for k in ("k1", "k1_backward", "k4")}},
        "phase_seconds": time.monotonic() - started,
    }
    print("shipped workload: " + json.dumps(out, sort_keys=True), flush=True)
    builds = ", ".join(f"{k} {v:.1f} s" for k, v in out["build_seconds"].items())
    print(f"shipped workload (phase 32): archive {out['archive_bytes']} bytes, "
          f"{out['archive_members']} members, ConfigMap {configmap_bytes} bytes; pip install "
          f"{install_s:.1f} s (pip {toolchain['pip']}, setuptools {toolchain['setuptools']}, "
          f"wheel {'present' if toolchain['wheel'] else 'absent'}); nvcc from the installed "
          f"sources: {builds}; LM Job "
          f"12L/768/seq 1024/batch 8: step {out['lm']['step_ms']:.2f} ms, "
          f"{out['lm']['tokens_per_sec']:.1f} tokens/s, K1 {out['lm']['launches']['k1']} + "
          f"{out['lm']['launches']['k1_backward']}, K2 "
          f"{out['lm']['launches']['k2_forward']} + {out['lm']['launches']['k2_backward']}, "
          f"step {out['lm']['final_step']} committed; ResNet-50 Job fused_1x1_bwd, batch "
          f"{out['resnet50']['global_batch']}: step "
          f"{out['resnet50']['step_ms']:.2f} ms, {out['resnet50']['images_per_sec']:.1f} img/s, "
          f"K1 {out['resnet50']['launches']['k1']} + {out['resnet50']['launches']['k1_backward']}, "
          f"K4 {out['resnet50']['launches']['k4']}; "
          f"{out['phase_seconds']:.1f} s; on {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 33: the resident supervisor co-driving the elastic trainer

# the drill's virtual timeline: 4 slices, a tick every 30 s, flap threshold
# 2; slice 3 is preempted mid-run, and a scoped replace takes 120 s
SUPERVISED = dict(num_slices=4, interval=30.0, preempt_at=200.0, step_s=13.0,
                  checkpoint_every=4, total_steps=24)
HEAL_SLICE_S = 120.0
# a sleeper on the virtual clock waits this long in real seconds for the
# other actor's real work (a step, a checkpoint, a rejoin) before it calls
# the clock stalled
SUPERVISED_STALL_S = 120.0


class SuperviseSim:
    """A scripted fleet for the supervisor on a virtual clock: slice health
    is a function of virtual time, and a `terraform apply -replace` costs
    `heal_seconds` on the clock before the slice returns. It implements the
    run / run_quiet pair that the supervisor's heal path consumes."""

    def __init__(self, root: pathlib.Path, clock, num_slices: int = 4,
                 heal_seconds: float = HEAL_SLICE_S) -> None:
        self.paths = RunPaths(root)
        self.paths.terraform_module("tpu-vm").mkdir(parents=True, exist_ok=True)
        self.config = ClusterConfig(project="sim-proj", zone="us-west4-a", generation="v5e",
                                    topology="4x4", mode="tpu-vm", num_slices=num_slices)
        self.clock = clock
        self.heal_seconds = heal_seconds
        self.num_slices = num_slices
        self.down: set = set()
        self.down_at: list = []
        self.applies: list = []
        self.ips = {i: f"10.0.{i}.1" for i in range(num_slices)}
        ClusterHosts(host_ips=[[self.ips[i]] for i in range(num_slices)],
                     internal_ips=[[f"10.1.{i}.1"] for i in range(num_slices)],
                     coordinator_ip="10.1.0.1").save(self.paths.hosts_file)
        self.paths.tfstate("tpu-vm").write_text(json.dumps(
            {"resources": [{"index": i} for i in range(num_slices)]}))

    def preempt(self, slice_index: int, at: float) -> None:
        self.down_at.append((at, slice_index))

    def sync(self) -> None:
        now = self.clock.time()
        for at, i in list(self.down_at):
            if now >= at:
                self.down.add(i)
                self.down_at.remove((at, i))

    def run(self, args, cwd=None, **kwargs) -> str:
        self.sync()
        if list(args[:2]) == ["terraform", "apply"]:
            replaced = [int(str(a).split("[")[1].rstrip("]"))
                        for a in args if str(a).startswith("-replace=")]
            self.applies.append(replaced)
            self.clock.sleep(self.heal_seconds)
            for i in replaced:
                self.down.discard(i)
                self.ips[i] = f"10.9.{i}.1"
        return ""

    def run_quiet(self, args, cwd=None, **kwargs) -> str:
        self.sync()
        if list(args[:3]) == ["terraform", "output", "-json"]:
            return json.dumps({
                "host_ips": {"value": [[self.ips[i]] for i in range(self.num_slices)]},
                "internal_ips": {"value": [[f"10.1.{i}.1"] for i in range(self.num_slices)]},
            })
        if args and args[0] == "gcloud":
            return "\n".join(f"{self.config.node_prefix}-{i}\tREADY"
                             for i in range(self.num_slices) if i not in self.down)
        if args and args[0] == "ssh":
            index = next((i for i, x in self.ips.items() if x == args[-2]), None)
            if "cat" in args[-1]:
                return ""
            if index in self.down:
                raise CommandError(list(args), 255)
        return ""


def supervised_elastic_drill(root: pathlib.Path, setup, batch_fn, checkpoint,
                             init_fn=lambda: None, shutdown_fn=lambda: None,
                             num_slices: int = 4, interval: float = 30.0,
                             preempt_at: float = 300.0, step_s: float = 1.5,
                             checkpoint_every: int = 30, total_steps: int = 400,
                             stall_timeout: float = 30.0, echo=lambda line: None) -> dict:
    """The elastic co-drive: the port's `Supervisor` reconciles a
    `SuperviseSim` on a `SimClock` in its own thread, while the port's
    `ElasticTrainer` trains whatever `setup()` builds against the
    supervisor's own fleet-status.json (`FileHealthSource`) and acknowledges
    through job-ack.json (`JobAck`). Each step is the session's step, then
    `step_s` virtual seconds, then the world's down check: a step that ends
    with a slice down raises, as a collective losing its peer does. The last
    slice is preempted at `preempt_at`. The defaults are the reference
    drill's (`bench_provision.run_elastic_drill`), whose report this
    returns, with the trainer's report, the ledger and the steps run."""
    clock = SimClock(stall_timeout=stall_timeout)
    world = SuperviseSim(root, clock, num_slices=num_slices)
    lost = num_slices - 1
    world.preempt(lost, at=preempt_at)
    policy = sup_mod.SupervisePolicy(interval=interval, flap_threshold=2)
    ledger = events.EventLedger(world.paths.events, clock=clock.time, echo=lambda line: None)
    supervisor = sup_mod.Supervisor(
        world.config, world.paths, chaos._Quiet(), run=world.run, run_quiet=world.run_quiet,
        policy=policy, ledger=ledger, clock=clock.time, sleep=clock.sleep, rng=lambda: 0.0,
        readiness_timeout=60.0)
    sup_ticks = int(total_steps * step_s / interval) + 4
    steps_run = [0]

    def session() -> elastic.TrainSession:
        built = setup()
        inner = built.step_fn

        def step_fn(state, *batch):
            out = inner(state, *batch)
            steps_run[0] += 1
            clock.sleep(step_s)
            world.sync()
            if world.down:
                raise RuntimeError("collective peer lost (slice preempted)")
            return out

        return dataclasses.replace(built, step_fn=step_fn)

    failures: list[BaseException] = []
    clock.launch()

    def sup_body() -> None:
        clock.begin()
        try:
            supervisor.run(ticks=sup_ticks)
        except BaseException as exc:  # re-raised after the trainer's run
            failures.append(exc)
        finally:
            clock.release()

    thread = threading.Thread(target=sup_body, daemon=True)
    thread.start()
    trainer = elastic.ElasticTrainer(
        session, batch_fn, checkpoint=checkpoint,
        health=elastic.FileHealthSource(world.paths.fleet_status),
        # polls every 17 s of virtual time, off the 30 s tick lattice: a
        # poll never lands on the instant of a status publish
        policy=elastic.ElasticPolicy(checkpoint_every=checkpoint_every, poll_every=1,
                                     wait_base_s=17.0, wait_cap_s=17.0, max_wait_s=900.0,
                                     max_degraded=0),
        ack=elastic.JobAck(world.paths.job_ack, clock=clock.time),
        init_fn=init_fn, shutdown_fn=shutdown_fn, drain_fn=None,
        clock=clock.time, sleep=clock.sleep, rng=lambda: 0.0, echo=echo)
    clock.launch()
    clock.begin()
    try:
        report = trainer.run(total_steps)
    finally:
        clock.release()
    thread.join(timeout=300)
    if thread.is_alive() or failures:
        raise AssertionError(f"supervisor thread: {failures or 'did not stop'}")
    records = ledger.replay()
    notified = [r for r in records if r["kind"] == events.JOB_NOTIFIED]
    resumed = [r for r in records if r["kind"] == events.JOB_RESUMED]
    resume = report["resumes"][-1] if report["resumes"] else {}
    budget = policy.flap_threshold * interval + HEAL_SLICE_S + 45.0
    return {
        "num_slices": num_slices, "interval_s": interval, "preempt_at_s": preempt_at,
        "lost_slice": lost, "step_s": step_s, "checkpoint_every_steps": checkpoint_every,
        "checkpoint_interval_s": checkpoint_every * step_s, "total_steps": total_steps,
        "final_step": report["final_step"], "steps_lost": report["steps_lost"],
        "resumes": len(report["resumes"]), "resume_degraded": bool(resume.get("degraded")),
        "waited_s": resume.get("waited_s"),
        "time_to_training_resumed_s": resume.get("ts", 0.0) - preempt_at if resume else None,
        "budget_s": budget, "heal_applies": list(world.applies),
        "ledger": {"job_notified": len(notified), "job_resumed": len(resumed),
                   "job_mttr_s": resumed[0].get("mttr_s") if resumed else None},
        "report": report, "records": records, "steps_run": steps_run[0], "trainer": trainer,
    }


def run_supervised_elastic(card: str) -> dict:
    """Phase 33: the reference's elastic co-drive with both halves the
    port's and the training real card work. The port's `Supervisor` ticks on
    a `SimClock` over `SuperviseSim`; slice 3 is preempted mid-run, detected,
    confirmed over two ticks and healed by one scoped replace, and
    fleet-status.json is published every tick. The port's `ElasticTrainer`
    trains the full-width LM of 7 (K1, K2) on a one-rank NCCL group: each
    step a real LM step, then the virtual step time and the down check;
    real `TrainCheckpointer` checkpoints. It fails unless the one heal is of
    slice 3 alone, the steps lost are at most a checkpoint interval, the
    ledger carries job-notified then job-resumed with an MTTR, the final
    parameters and momentum equal an uninterrupted run's to the bit, and K1
    and K2 launched once and 12 + 12 times for every step run."""
    started = time.monotonic()
    steps = SUPERVISED["total_steps"]
    with tempfile.TemporaryDirectory() as tmp:
        stores = iter(range(1000))

        def join():
            dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store{next(stores)}", 1),
                                    rank=0, world_size=1)

        def setup() -> elastic.TrainSession:
            mesh = mesh_lib.make_mesh(device_type="cuda")
            state = train.create_train_state(_lm_model(), train.default_optimizer(MESH_LR["lm"]),
                                             "cuda", mesh=mesh)
            return elastic.TrainSession(state, None,
                                        elastic.state_step_fn(train.make_lm_train_step(state)),
                                        mesh)

        def batch_fn(session, step: int) -> tuple:
            return (_elastic_tokens(step),)

        # the uninterrupted run on the same path; it also compiles the step
        # and loads K1 and K2 before the virtual clock starts
        join()
        try:
            session = setup()
            times = []
            for i in range(steps):
                t0 = time.monotonic()
                session.step_fn(session.state, *batch_fn(session, i))[1]["loss"].item()
                times.append(1e3 * (time.monotonic() - t0))
            straight = _lm_values(session.state)
            del session
        finally:
            distributed.shutdown()
        torch.cuda.empty_cache()

        ckpt = _TimedCheckpoint(lambda: ckpt_lib.TrainCheckpointer(f"{tmp}/ckpt"))
        drill_root = pathlib.Path(tmp) / "fleet"
        drill_root.mkdir()
        t0 = time.monotonic()
        try:
            drill, counts = _counted(lambda: supervised_elastic_drill(
                drill_root, setup, batch_fn, ckpt, init_fn=join,
                shutdown_fn=distributed.shutdown, stall_timeout=SUPERVISED_STALL_S,
                echo=lambda line: print(f"phase 33: {line}", flush=True), **SUPERVISED))
            drill_s = time.monotonic() - t0
            trainer = drill.pop("trainer")
            resumed = _lm_values(trainer.session.state)
            final_step = trainer.session.state.step
        finally:
            distributed.shutdown()
    records = drill.pop("records")
    kinds = [r["kind"] for r in records]
    diffs = [(resumed[k] - v).abs().max().item() for k, v in straight.items()]
    max_diff = max(diffs)
    run = drill["steps_run"]
    report = drill.pop("report")
    implied = steps + report["steps_lost"] + len(report["resumes"])
    resumed_rec = next((r for r in records if r["kind"] == events.JOB_RESUMED), {})
    out = {**drill, "trainer_resumes": report["resumes"], "max_abs_diff": max_diff,
           "bit_equal": max_diff == 0.0, "final_step": final_step, "launches": counts,
           "step_ms": times, "save_s": ckpt.seconds["save"], "restore_s": ckpt.seconds["restore"],
           "drill_seconds": drill_s, "phase_seconds": time.monotonic() - started,
           "ledger_kinds": sorted(set(kinds))}
    print(f"supervised elastic (phase 33), the port's Supervisor on a SimClock over 4 slices "
          f"(interval {SUPERVISED['interval']:.0f} s, flap threshold 2) and the LM 12L/768/seq "
          f"1024/batch 8 bf16 under ElasticTrainer on a one-rank NCCL group, {steps} steps of "
          f"{SUPERVISED['step_s']} virtual s, checkpoint every {SUPERVISED['checkpoint_every']}, "
          f"slice 3 preempted at t={SUPERVISED['preempt_at']:.0f} s: heal applies "
          f"{drill['heal_applies']}, virtual time to training resumed "
          f"{drill['time_to_training_resumed_s']} s (budget {drill['budget_s']} s), waited "
          f"{drill['waited_s']} s, steps lost {drill['steps_lost']}, resumes {drill['resumes']}, "
          f"ledger {drill['ledger']}; final parameters and momentum against an uninterrupted "
          f"run: max |diff| {max_diff!r} (tolerance 0); LM steps run {run} (implied {implied}), "
          f"launches {counts}; uninterrupted step ms "
          f"{statistics.median(times[1:]):.2f} (median, host clock, each ended by "
          f"loss.item()); drill {drill_s:.1f} s, phase {out['phase_seconds']:.1f} s wall; on "
          f"{card}", flush=True)
    if (drill["heal_applies"] != [[3]] or drill["steps_lost"] > SUPERVISED["checkpoint_every"]
            or drill["resumes"] < 1 or drill["final_step"] != steps or final_step != steps
            or max_diff != 0.0):
        raise AssertionError(f"supervised elastic drill: {out}")
    if (events.JOB_NOTIFIED not in kinds or events.JOB_RESUMED not in kinds
            or kinds.index(events.JOB_NOTIFIED) > kinds.index(events.JOB_RESUMED)
            or resumed_rec.get("mttr_s") is None):
        raise AssertionError(f"supervised elastic drill: ledger {kinds}")
    if run != implied or (counts["k1"], counts["k1_backward"], counts["k2_forward"],
                          counts["k2_backward"]) != (run, run, 12 * run, 12 * run):
        raise AssertionError(f"supervised elastic drill: launches {counts} for {run} steps run "
                             f"({implied} implied)")
    return out


# the worked example of docs/detailed.md ("Training on real text") at its
# widths; steps, warm-up and decay cut from 500 warm-up and 20,000 decay
# steps to fit the phase in about a minute
WORKED_LM = dict(vocab_size=256, num_layers=12, num_heads=12, embed_dim=768, max_seq_len=1024)
WORKED_BATCH = 32
WORKED_STEPS = 60
WORKED_OPT = dict(learning_rate=3e-4, warmup_steps=20, decay_steps=200)
WORKED_TIMED_FROM = 5  # steps before this one build, load and warm up
WORKED_MEAN_OF = 10  # the loss falls: the mean of the last 10 steps below the first 10's
WORKED_PROMPT = 64
WORKED_NEW_TOKENS = 128  # cut from 256 to keep the whole script inside its time limit
CONTAINERBENCH_TIMEOUT_S = 300


def worked_example_ids() -> np.ndarray:
    """The phase's corpus: the bytes of docs/*.md beside this script, in
    sorted name order (files that predate the port; README.md, which
    every change edits, is left out, so the corpus is the same in every
    run of every tree)."""
    docs = sorted((pathlib.Path(__file__).resolve().parent / "docs").glob("*.md"))
    return corpus.ByteTokenizer().encode(b"".join(p.read_bytes() for p in docs))


def worked_example_prompt(val_ids: np.ndarray) -> np.ndarray:
    """The first 64 bytes of the first held-out line that starts with a
    capital letter and holds at least 64 bytes: prose, not a table row."""
    start = 0
    for line in val_ids.astype(np.uint8).tobytes().split(b"\n"):
        if len(line) >= WORKED_PROMPT and line[:1].isupper():
            return val_ids[start:start + WORKED_PROMPT]
        start += len(line) + 1
    raise AssertionError("worked example: no held-out line for the prompt")


def worked_example_k2_row() -> dict:
    """K2 forward and backward at the worked example's attention:
    (32, 1024, 12, 64) bf16 causal bshd."""
    heads = WORKED_LM["num_heads"]
    return check_k2(WORKED_BATCH, WORKED_LM["max_seq_len"], heads,
                    WORKED_LM["embed_dim"] // heads, causal=True, layout="bshd", seed=6)


def worked_example_k3_rows() -> list:
    """K3 at the worked example's int8 `generate`: batch 1 over the
    1024-position blhd cache, at its first and last decode positions (the
    prompt's length, and that plus WORKED_NEW_TOKENS - 2)."""
    heads = WORKED_LM["num_heads"]
    shape = (1, 1, heads, WORKED_LM["max_seq_len"], WORKED_LM["embed_dim"] // heads)
    first, last = WORKED_PROMPT, WORKED_PROMPT + WORKED_NEW_TOKENS - 2
    return [check_k3(f"worked example generate, pos {last}", *shape, last, seed=14),
            check_k3(f"worked example generate, pos {first}", *shape, first, seed=15)]


def _plain_k3_logits(model, params, prompt, tokens) -> torch.Tensor:
    """`_decode_logits` with K3's plain version in K3's place in
    models/decode.py; fails if K3 launched."""
    kernel, before = dec.decode_attention_int8, da.decode_attention_kernel.launches
    dec.decode_attention_int8 = da.decode_attention_int8_plain
    try:
        logits = _decode_logits(model, params, prompt, tokens)
    finally:
        dec.decode_attention_int8 = kernel
    if da.decode_attention_kernel.launches != before:
        raise AssertionError("worked example: K3 launched in place of its plain version")
    return logits


def run_containerbench() -> list:
    """`python -m ...benchmarks.containerbench --json` at its defaults (1 GiB
    written and fsync'd, 256 MiB hashed) in a temporary directory: the card
    machine's host disk and CPU, not the card."""
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [sys.executable, "-m", "tritonk8ssupervisor_tpu_torch.benchmarks.containerbench",
             "--json", "--workdir", tmp], capture_output=True, text=True,
            timeout=CONTAINERBENCH_TIMEOUT_S, cwd=pathlib.Path(__file__).resolve().parent)
        if out.returncode != 0:
            raise AssertionError(f"containerbench exited {out.returncode}: {out.stderr[-2000:]}")
        left = os.listdir(tmp)
    records = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    if [r["workload"] for r in records] != ["disk", "cpu"] or left:
        raise AssertionError(f"containerbench: records {records}, left behind {left}")
    return records


def run_worked_example(card: str) -> dict:
    """Phase 34: the worked example of docs/detailed.md at full width on
    the card. The bytes of docs/*.md (`worked_example_ids`) through
    `corpus.ByteTokenizer`, split by `train_val_split(val_fraction=0.1)`;
    `TransformerLM(vocab_size=256, num_layers=12, num_heads=12,
    embed_dim=768, max_seq_len=1024)` in its bf16 defaults with
    `attention_fn=flash_attention` (the LM benchmark's choice: dense
    attention at batch 32 would hold 12 layers of (32, 12, 1024, 1024)
    scores, so it is not run); `lm_optimizer(learning_rate=3e-4)` on
    `make_lm_train_step` over a one-rank NCCL mesh, fed by
    `corpus.batches(batch_size=32, seq_len=1024)` through
    `utils/data.prefetch_to_mesh`. The cut: 60 steps with warm-up 20 and
    decay 200, instead of the example's warm-up 500 and decay 20,000; the
    widths are the example's. It fails unless the mean loss of the last 10
    steps is below the first 10's, the held-out loss of
    `make_lm_eval_step` on one validation batch falls, its perplexity is
    finite and below 256 (uniform over the bytes), K1 launches once a train
    step and once an eval call and K2 12 + 12 times a train step and 12
    times an eval call. Then greedy `models/decode.generate` of 128 tokens
    from 64 bytes of the validation text (`worked_example_prompt`), with
    the default cache and with
    the int8 cache: K3 exactly 12 x 127 times with the int8 cache and never
    with the other, each output decodable and not one repeated byte; the
    int8 cache's logits of every step, fed the int8 output, through K3
    within WORKED_K3_LOGITS_REL of the same steps with K3's plain version
    in its place. K1 at
    this path's (32768, 256) bf16 against its plain version,
    `F.cross_entropy` and its bound; and the containerbench host numbers."""
    started = time.monotonic()
    ids = worked_example_ids()
    train_ids, val_ids = corpus.train_val_split(ids, val_fraction=0.1)
    layers = WORKED_LM["num_layers"]
    tokens_per_step = WORKED_BATCH * WORKED_LM["max_seq_len"]
    k1_row = check_k1(tokens_per_step, WORKED_LM["vocab_size"], seed=34, dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    seq = WORKED_LM["max_seq_len"]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1)
        try:
            mesh = mesh_lib.make_mesh(device_type="cuda")
            model = TransformerLM(**WORKED_LM, attention_fn=fa.flash_attention)
            state = train.create_train_state(model, train.lm_optimizer(**WORKED_OPT), "cuda",
                                             mesh=mesh)
            step = train.make_lm_train_step(state)
            eval_step = train.make_lm_eval_step(state)
            val = global_batch_from_local(mesh, next(corpus.batches(
                val_ids, WORKED_BATCH, seq, seed=1)))
            counters = _k1_k2_counters()
            for counter in counters:
                counter.launches = 0
            fa.flash_attention_forward.copies = 0
            val_before = float(eval_step(val)["loss"])
            eval_counts = tuple(c.launches for c in counters)
            losses = []
            stream = prefetch_to_mesh(corpus.batches(train_ids, WORKED_BATCH, seq,
                                                     steps=WORKED_STEPS), mesh)
            for i, tokens in enumerate(stream):
                if i == WORKED_TIMED_FROM:
                    torch.cuda.synchronize()
                    timed_from = time.monotonic()
                losses.append(step(tokens)["loss"].detach())
                if i == 0:
                    first_counts = tuple(c.launches - n for c, n in zip(counters, eval_counts))
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.monotonic() - timed_from) / (WORKED_STEPS - WORKED_TIMED_FROM)
            val_after = float(eval_step(val)["loss"])
            counts = {"k1": ce.cross_entropy_forward.launches,
                      "k1_backward": ce.cross_entropy_backward.launches,
                      "k2_forward": fa.flash_attention_forward.launches,
                      "k2_backward": fa.flash_attention_backward.launches,
                      "k2_copies": fa.flash_attention_forward.copies}
            peak = torch.cuda.max_memory_allocated()
        finally:
            dist.destroy_process_group()
    losses = [float(x) for x in torch.stack(losses).float().cpu()]
    first, last = statistics.fmean(losses[:WORKED_MEAN_OF]), statistics.fmean(
        losses[-WORKED_MEAN_OF:])
    ppl_before, ppl = math.exp(val_before), math.exp(val_after)
    steps = len(losses)
    evals = 2
    expected = {"k1": steps + evals, "k1_backward": steps, "k2_forward": layers * (steps + evals),
                "k2_backward": layers * steps, "k2_copies": 0}
    train_s = time.monotonic() - started

    # serving the trained weights, greedy, with each cache
    params = dec.lm_params(state.model, "cuda")
    prompt_ids = worked_example_prompt(val_ids)
    prompt = torch.from_numpy(prompt_ids[None, :].astype(np.int32)).cuda()
    decode = {}
    for name, int8 in (("default_cache", False), ("cache_int8", True)):
        dec.generate(state.model, params, prompt, 8, cache_int8=int8)  # warm-up
        torch.cuda.synchronize()
        da.decode_attention_kernel.launches = 0
        t0 = time.monotonic()
        generated = dec.generate(state.model, params, prompt, WORKED_NEW_TOKENS, cache_int8=int8)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        tokens = generated[0].cpu().tolist()
        if len(set(tokens)) < 2:
            raise AssertionError(f"worked example: generate collapsed to byte {tokens[:1]}")
        decode[name] = {"ms_per_token": 1e3 * wall / WORKED_NEW_TOKENS,
                        "k3": da.decode_attention_kernel.launches,
                        "text": corpus.ByteTokenizer().decode(tokens),
                        "distinct_bytes": len(set(tokens)), "tokens": tokens}
    # K3 on this path against its plain version: the int8 cache's logits
    # of every step, fed the int8 greedy tokens, through K3 and then
    # through the plain version in its place
    forced = torch.tensor([decode["cache_int8"]["tokens"]], dtype=torch.int32, device="cuda")
    got = _decode_logits(state.model, params, prompt, forced)
    want = _plain_k3_logits(state.model, params, prompt, forced)
    del params
    top2 = want.topk(2, dim=-1).values
    same_prefix = next((i for i, (a, b) in enumerate(zip(decode["default_cache"]["tokens"],
                                                           decode["cache_int8"]["tokens"]))
                        if a != b), WORKED_NEW_TOKENS)
    k3_path = {"max_abs_err": (got - want).abs().max().item(),
               "max_abs_logit": want.abs().max().item(),
               "argmax_differs": int((got.argmax(-1) != want.argmax(-1)).sum()),
               "min_top2_margin": (top2[..., 0] - top2[..., 1]).min().item(),
               "int8_tokens_equal_default_cache_for": same_prefix}
    k3_path["rel_err"] = k3_path["max_abs_err"] / k3_path["max_abs_logit"]
    bench = run_containerbench()
    out = {
        "steps": steps, "step_ms": step_ms, "tokens_per_sec": tokens_per_step / step_ms * 1e3,
        "loss_first": losses[0], "loss_last": losses[-1],
        f"loss_mean_first_{WORKED_MEAN_OF}": first,
        f"loss_mean_last_{WORKED_MEAN_OF}": last, "val_loss_before": val_before,
        "val_loss_after": val_after, "val_perplexity_before": ppl_before,
        "val_perplexity": ppl, "launches": counts, "first_step_launches": first_counts,
        "k3_against_plain_on_path": k3_path,
        "eval_launches": eval_counts, "peak_memory_bytes": peak, "decode": decode,
        "k1": k1_row, "containerbench_host": bench, "corpus_bytes": len(ids),
        "prompt": corpus.ByteTokenizer().decode(prompt_ids),
        "train_bytes": len(train_ids), "val_bytes": len(val_ids),
        "train_seconds": train_s, "phase_seconds": time.monotonic() - started,
    }
    print(f"worked example (phase 34), docs/*.md ({len(ids)} bytes, {len(train_ids)} train, "
          f"{len(val_ids)} held out) through ByteTokenizer, TransformerLM 12L/12H/768 vocab 256 "
          f"seq 1024 bf16 with flash attention at batch 32 on a one-rank NCCL mesh, "
          f"lm_optimizer({WORKED_OPT['learning_rate']:g}, warm-up "
          f"{WORKED_OPT['warmup_steps']}, decay {WORKED_OPT['decay_steps']}), {steps} steps "
          f"through prefetch_to_mesh: step "
          f"{step_ms:.2f} ms (host clock over steps {WORKED_TIMED_FROM}-{steps - 1}), "
          f"{out['tokens_per_sec']:.1f} tokens/s, peak memory {peak / 1e9:.2f} GB; train loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first {WORKED_MEAN_OF} {first:.4f}, "
          f"of the last {last:.4f}); held-out loss {val_before:.4f} -> {val_after:.4f}, "
          f"perplexity {ppl_before:.2f} -> {ppl:.2f} (uniform 256); on {card}", flush=True)
    for name, d in decode.items():
        print(f"worked example: greedy generate, the {WORKED_PROMPT}-byte held-out prompt "
              f"{corpus.ByteTokenizer().decode(prompt_ids)!r}, {WORKED_NEW_TOKENS} new tokens, "
              f"{name}: {d['ms_per_token']:.3f} ms a "
              f"token (host clock, batch 1), K3 launches {d['k3']}, {d['distinct_bytes']} "
              f"distinct bytes: {d['text']!r} on {card}", flush=True)
    print(f"worked example: int8-cache logits of {WORKED_NEW_TOKENS} steps along the int8 "
          f"greedy tokens, K3 against its plain version in its place: max |diff| "
          f"{k3_path['max_abs_err']:.4e} of max |logit| {k3_path['max_abs_logit']:.4f} "
          f"(relative {k3_path['rel_err']:.3e}, tolerance {WORKED_K3_LOGITS_REL:g}), argmax "
          f"differs at {k3_path['argmax_differs']} steps (least top-2 margin "
          f"{k3_path['min_top2_margin']:.4f}); the int8 and default-cache outputs agree for "
          f"the first {same_prefix} tokens, on {card}", flush=True)
    print(f"{_k1_text(k1_row, card)} (the worked example's loss)", flush=True)
    print(f"worked example launches: {counts} in {steps} train steps and {evals} eval calls "
          f"(expected {expected}); first train step {first_counts}, one eval call {eval_counts}",
          flush=True)
    for r in bench:
        print(f"containerbench (the card machine's host, not the card): /{r['workload']} "
              f"{r['bytes']} bytes in {r['seconds']:.3f} s, {r['mb_per_sec']:.2f} MB/s",
              flush=True)
    print(f"worked example: phase {out['phase_seconds']:.1f} s wall (training "
          f"{train_s:.1f} s)", flush=True)
    if not (last < first and val_after < val_before and math.isfinite(ppl) and ppl < 256.0):
        raise AssertionError(f"worked example did not learn: {out}")
    if (counts != expected or first_counts != (1, 1, layers, layers)
            or eval_counts != (1, 0, layers, 0)):
        raise AssertionError(f"worked example launches {counts}, first step {first_counts}, "
                             f"eval {eval_counts}; expected {expected}")
    if (decode["cache_int8"]["k3"] != layers * (WORKED_NEW_TOKENS - 1)
            or decode["default_cache"]["k3"] != 0):
        raise AssertionError(f"worked example: K3 launches {decode}")
    if not k3_path["rel_err"] <= WORKED_K3_LOGITS_REL:
        raise AssertionError(f"worked example: K3 and its plain version disagree: {k3_path}")
    return out


# ---------------------------------------------------------------------------
# Phase 35: provisioning through the wizard, the compiled LM Job, its roofline

# the cloud's command-line tools as sh stubs that log their calls (the
# recipe of tests/test_torch_cli_provision.py): they stand in for GCP,
# which the card machine cannot reach, never for the card
PROVISION_STUBS = {
    "terraform": """#!/bin/sh
echo "terraform $*" >> "$CALLS_LOG"
case "$1" in
  apply) echo '{"resources": [{"type": "google_container_node_pool"}]}' > terraform.tfstate ;;
  output) echo '{"host_ips": {"value": [["10.0.0.1"]]}}' ;;
  destroy) rm -f terraform.tfstate ;;
esac
""",
    "ansible-playbook": '#!/bin/sh\necho "ansible-playbook $*" >> "$CALLS_LOG"\n',
    "gcloud": """#!/bin/sh
echo "gcloud $*" >> "$CALLS_LOG"
case "$*" in
  "config get-value project") echo smoke-proj ;;
  "config get-value account") echo smoke@stub.test ;;
esac
""",
    "ssh-keygen": '#!/bin/sh\necho "ssh-keygen $*" >> "$CALLS_LOG"\n',
    "ssh": '#!/bin/sh\necho "ssh $*" >> "$CALLS_LOG"\n',
    "kubectl": """#!/bin/sh
echo "kubectl $*" >> "$CALLS_LOG"
echo '{"items": [{"metadata": {"name": "n1"}, "status": {"allocatable": {"google.com/tpu": "4"}, "conditions": [{"type": "Ready", "status": "True"}]}}]}'
""",
}
# the wizard's answers in its order (project, env name, env description,
# cluster name, node prefix, mode, generation, topology, slices, zone,
# network, subnetwork): a GKE cluster, the catalog's defaults (one v5e 2x2
# slice, one host); then "yes" at the verification gate
PROVISION_ANSWERS = ["", "", "", "smoke-cluster", "", "1", "", "", "", "", "", "", "yes"]
PROVISION_TASKS = ["terraform-apply", "compile-manifests", "host-configuration",
                   "readiness-wait"]
PROVISION_MANIFESTS = ["bench-job-0.yaml", "bench-service.yaml", "package-configmap.yaml"]
ROOFLINE_BUSY_RTOL = 0.02  # the roofline's device time against summary.json's busy time
# no kernel may read above this share of the tensor-core peak, nor of the
# memory peak where its traffic a call exceeds the L2: smaller operands can
# be served from the L2 (the residual stream's add reads 3 x 12.6 MB that
# the step wrote just before, at 3.6-3.9 TB/s on the H100)
ROOFLINE_PEAK_CAP = 1.05
LM_K2_SHAPE = (8, 12, 1024, 64)  # (batch, heads, seq, head_dim) of the LM


@contextlib.contextmanager
def _stub_world(root: pathlib.Path, stubs: dict = PROVISION_STUBS):
    """PATH, HOME, CALLS_LOG and a deterministic retry for the duration,
    then the process environment as it was."""
    bin_dir = root / "bin"
    bin_dir.mkdir()
    for name, body in stubs.items():
        (bin_dir / name).write_text(body)
        (bin_dir / name).chmod(0o755)
    (root / "home" / ".ssh").mkdir(parents=True)
    (root / "home" / ".ssh" / "id_rsa").write_text("stub-key\n")
    saved = dict(os.environ)
    os.environ.update(PATH=f"{bin_dir}:{saved.get('PATH', '')}", HOME=str(root / "home"),
                      CALLS_LOG=str(root / "calls.log"), TK8S_SSH_USER="smoke",
                      TK8S_RETRY_BASE_DELAY="0.01", TK8S_RETRY_MAX_DELAY="0.02")
    for name in ("TK8S_FAULT_PLAN", "TK8S_BENCH_WORKLOAD", "TK8S_BENCH_FLAGS",
                 "TK8S_CHECKPOINT_DIR", "BENCH_IMAGE", "TK8S_SCHED_WORKERS"):
        os.environ.pop(name, None)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def _cli(argv: list[str], answers: list[str], calls_log: pathlib.Path) -> tuple:
    """cli.main(argv) with `answers` on its prompter: (exit code, stdout,
    stderr, the stub calls it made)."""
    from tritonk8ssupervisor_tpu_torch.cli.io import Prompter

    calls_log.write_text("")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv, Prompter(io.StringIO("".join(f"{a}\n" for a in answers)), out))
    return rc, out.getvalue(), err.getvalue(), calls_log.read_text().splitlines()


def provision_lm_job(root: pathlib.Path, profile_dir: pathlib.Path) -> dict:
    """Phase 35's provisioning half in the stub world: the wizard, the
    resume, --show-config and -c; returns the bench Job it compiled."""
    from tritonk8ssupervisor_tpu_torch.cli import wizard
    from tritonk8ssupervisor_tpu_torch.config import store

    work = root / "repo"
    for sub in ("terraform/tpu-vm", "terraform/gke", "ansible"):
        (work / sub).mkdir(parents=True)
    (work / "ansible" / "ansible.cfg").write_text(
        "[defaults]\nhost_key_checking = False\nprivate_key_file =\n")
    (work / "ansible" / "clusterUp.yml").write_text("[]\n")
    paths = RunPaths(work)
    calls_log = root / "calls.log"
    flags = " ".join([*SHIPPED_FLAGS["lm"], "--profile", str(profile_dir)])
    argv = ["--workdir", str(work), "--bench-workload", "lm", "--bench-flags", flags]
    with _stub_world(root):
        started = time.monotonic()
        rc, out, err, calls = _cli(argv, PROVISION_ANSWERS, calls_log)
        provision_s = time.monotonic() - started
        manifests = sorted(p.name for p in paths.manifests_dir.iterdir())
        journal = [json.loads(line) for line in paths.journal.read_text().splitlines()]
        config = store.load_config_file(paths.config_file)
        if (rc != 0 or "Cluster is ready" not in out or "Verify the configuration:" not in out
                or config.mode != "gke" or config.cluster_name != "smoke-cluster"
                or not paths.hosts_file.is_file() or manifests != PROVISION_MANIFESTS
                or sorted(r["task"] for r in journal) != sorted(PROVISION_TASKS)
                or {r["status"] for r in journal} != {"done"}
                or not any(c.startswith("terraform apply") for c in calls)
                or not any(c.startswith("kubectl get nodes") for c in calls)):
            raise AssertionError(f"provision through the wizard exited {rc}, manifests "
                                 f"{manifests}, journal {journal}, calls {calls}: "
                                 f"{out[-3000:]} {err[-3000:]}")
        job = yaml.safe_load((paths.manifests_dir / "bench-job-0.yaml").read_text())

        resumed = _cli(argv, ["yes"], calls_log)
        skipped = resumed[2].count("journal-verified; skipping")
        if (resumed[0] != 0 or "Previous run detected" not in resumed[1]
                or skipped != len(PROVISION_TASKS)
                or [c for c in resumed[3] if not c.startswith("gcloud ")]):
            raise AssertionError(f"the resumed provision exited {resumed[0]}, skipped "
                                 f"{skipped} of {len(PROVISION_TASKS)} tasks, calls "
                                 f"{resumed[3]}: {resumed[1][-2000:]} {resumed[2][-2000:]}")

        shown = _cli(["--show-config", "--workdir", str(work)], [], calls_log)
        rows = wizard.config_rows(config)
        if shown[0] != 0 or not all(f"  {label:<24} {value}" in shown[1]
                                    for label, value in rows):
            raise AssertionError(f"--show-config exited {shown[0]}: {shown[1]}")

        cleaned = _cli(["-c", "--yes", "--workdir", str(work)], [], calls_log)
        left = [p for p in (paths.config_file, paths.hosts_file, paths.journal,
                            paths.tfstate("gke"), paths.manifests_dir) if p.exists()]
        if (cleaned[0] != 0 or left
                or not any(c.startswith("terraform destroy") for c in cleaned[3])):
            raise AssertionError(f"-c --yes exited {cleaned[0]}, left {left}, calls "
                                 f"{cleaned[3]}: {cleaned[1][-2000:]}")
    return {"job": job, "provision_seconds": provision_s, "tasks_skipped_on_resume": skipped,
            "show_config_rows": len(rows), "stub_calls": len(calls),
            "transcript_lines": len(out.splitlines())}


def check_lm_roofline(profile_dir: pathlib.Path) -> dict:
    """The roofline of the Job's profiled step, from the port's CLI (--json
    in a process of its own, the text through the same `main` in this one;
    printed) and in process, held to its checks."""
    root = pathlib.Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root)}
    out = subprocess.run([sys.executable, "-m", "tritonk8ssupervisor_tpu_torch.utils.roofline",
                          str(profile_dir), "--json"], cwd=root, env=env, capture_output=True,
                         text=True, timeout=300)
    if out.returncode:
        raise AssertionError(f"roofline --json exited {out.returncode}: {out.stderr}")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        code = roofline.main([str(profile_dir)])
    if code:
        raise AssertionError(f"roofline's text report returned {code}")
    runs = {"json": out.stdout, "text": text.getvalue()}
    for line in runs["text"].splitlines():
        print(f"roofline: {line}", flush=True)
    as_json = json.loads(runs["json"])
    report = roofline.analyze(str(profile_dir))
    summary = json.loads((profile_dir / "summary.json").read_text())
    busy = summary["device_busy_ms"]

    def by(category: str) -> tuple[float, float, float, int]:
        ops = [op for op in report.ops if op.category == category]
        return (sum(op.duration_ms for op in ops), sum(op.bytes_accessed for op in ops),
                sum(op.flops for op in ops), sum(op.occurrences for op in ops))

    k1 = by("tk8s::cross_entropy_fwd")
    k1_bwd = by("tk8s::cross_entropy_bwd")
    k2, k2_bwd = by("tk8s::flash_attn_fwd"), by("tk8s::flash_attn_bwd")
    b, h, s, d = LM_K2_SHAPE
    layers = 12
    k1_bytes = ce.forward_cost(b * s, 32768, 2, 4)[0]
    k2_flops = layers * fa.forward_cost(b, h, s, d, True, 2)[1]
    k2_bwd_flops = layers * fa.backward_cost(b, h, s, d, True, 2)[1]
    l2_bytes = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 * 2**20)
    over_hbm = [op for op in report.ops
                if op.gbytes_per_sec * 1e9 > ROOFLINE_PEAK_CAP * report.peak_bytes_per_sec]
    over = [(op.category, op.name, op.gbytes_per_sec, op.tflops_per_sec) for op in report.ops
            if (op in over_hbm and op.bytes_accessed / op.occurrences > l2_bytes)
            or op.tflops_per_sec * 1e12 > ROOFLINE_PEAK_CAP * report.peak_flops_per_sec]
    out = {
        "device_ms": report.total_ms, "summary_busy_ms": busy,
        "summary_wall_ms": summary["wall_ms"], "traffic_gb": report.total_bytes / 1e9,
        "tflop": report.total_flops / 1e12, "hbm_bound_ms": report.hbm_bound_ms,
        "tensor_core_bound_ms": report.mxu_bound_ms, "hbm_efficiency": report.hbm_efficiency,
        "clawback_ms": sum(op.duration_ms for op in report.clawback()),
        "by_category_ms": dict(sorted(report.by_category_ms.items(), key=lambda kv: -kv[1])),
        "k1_forward": {"ms": k1[0], "bytes": k1[1], "formula_bytes": k1_bytes,
                       "of_hbm_peak": k1[1] / (k1[0] / 1e3) / report.peak_bytes_per_sec
                       if k1[0] else None, "kernels": k1[3]},
        "k1_backward": {"ms": k1_bwd[0], "bytes": k1_bwd[1], "kernels": k1_bwd[3]},
        "k2_forward": {"ms": k2[0], "flops": k2[2], "formula_flops": k2_flops,
                       "kernels": k2[3]},
        "k2_backward": {"ms": k2_bwd[0], "flops": k2_bwd[2], "formula_flops": k2_bwd_flops,
                        "kernels": k2_bwd[3]},
        "json_keys": sorted(as_json),
        "l2_bytes": l2_bytes,
        # above the memory peak with a call's traffic within the L2
        "l2_served": [{"category": op.category, "kernel": op.name[:80],
                       "gbytes_per_sec": op.gbytes_per_sec,
                       "bytes_per_call": op.bytes_accessed / op.occurrences}
                      for op in over_hbm],
    }
    for r in out["l2_served"]:
        print(f"roofline: {r['category']} {r['kernel']} at {r['gbytes_per_sec']:.0f} GB/s, "
              f"{r['bytes_per_call'] / 1e6:.1f} MB a call: within the L2's "
              f"{l2_bytes / 1e6:.1f} MB", flush=True)
    if not (report.peak_bytes_per_sec and report.peak_flops_per_sec and busy
            and abs(report.total_ms - busy) <= ROOFLINE_BUSY_RTOL * busy
            and math.isclose(as_json["total_ms"], report.total_ms, rel_tol=1e-9)
            and k1[1] == k1_bytes and k1[3] == 1
            and math.isclose(k2[2], k2_flops, rel_tol=1e-12)
            and math.isclose(k2_bwd[2], k2_bwd_flops, rel_tol=1e-12) and not over):
        raise AssertionError(f"the LM Job's roofline: {out}, above {ROOFLINE_PEAK_CAP:.0%} of "
                             f"a peak: {over}")
    return out


def run_provision_roofline(card: str) -> dict:
    """Phase 35: provision through the wizard in a stub world, the compiled
    LM Job's workload on the card from the checkout, and its roofline."""
    started = time.monotonic()
    root_dir = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        profile_dir = root / "profile"
        provisioned = provision_lm_job(root, profile_dir)
        argv, job_env = _job_workload(provisioned.pop("job"))
        module = "tritonk8ssupervisor_tpu_torch.benchmarks.lm"
        if (argv[:3] != ["python", "-m", module] or "--json" not in argv
                or argv[argv.index("--profile") + 1] != str(profile_dir)):
            raise AssertionError(f"the provisioned LM Job's workload: {argv}")
        counts_file = root / "counts.json"
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(job_env, PYTHONPATH=str(root_dir), TK8S_SMOKE_COUNTS=str(counts_file))
        run_started = time.monotonic()
        out = subprocess.run([sys.executable, "-c", SHIPPED_CHILD, *argv[2:]], cwd=root_dir,
                             env=env, capture_output=True, text=True,
                             timeout=SHIPPED_RUN_TIMEOUT_S)
        run_s = time.monotonic() - run_started
        if out.returncode:
            raise AssertionError(f"the LM Job's workload exited {out.returncode}: "
                                 f"{out.stderr[-3000:]}")
        report = json.loads(out.stdout.strip().splitlines()[-1])
        counts = json.loads(counts_file.read_text())
        steps, layers = report["final_step"], report.get("num_layers")
        launches = (counts["k1"], counts["k1_backward"], counts["k2_forward"],
                    counts["k2_backward"])
        if (report["platform"] != "gpu" or not math.isfinite(report["final_loss"])
                or (layers, report.get("seq_len"), report.get("embed_dim"),
                    report.get("global_batch")) != (12, 1024, 768, 8)
                or not counts["package"].startswith(str(root_dir))
                or launches != (steps, steps, layers * steps, layers * steps) or not steps):
            raise AssertionError(f"the LM Job's workload: launches {launches} in {steps} "
                                 f"steps, package {counts['package']}, report {report}")
        lm_roofline = check_lm_roofline(profile_dir)
    result = {
        **provisioned, "argv": argv, "step_ms": report["step_ms"],
        "step_ms_windows": report.get("step_ms_windows"),
        "tokens_per_sec": report["tokens_per_sec"], "final_step": steps,
        "run_seconds": run_s,
        "launches": {"k1": launches[0], "k1_backward": launches[1], "k2_forward": launches[2],
                     "k2_backward": launches[3]},
        "roofline": lm_roofline, "phase_seconds": time.monotonic() - started,
    }
    r = lm_roofline
    print("provision roofline: " + json.dumps(result, sort_keys=True, default=str), flush=True)
    print(f"provision roofline (phase 35): provisioned a gke v5e 2x2 cluster through the wizard "
          f"in {provisioned['provision_seconds']:.2f} s of stub calls, resumed with "
          f"{provisioned['tasks_skipped_on_resume']} tasks skipped, shown and cleaned; the LM "
          f"Job 12L/768/seq 1024/batch 8 from the checkout: step {report['step_ms']:.2f} ms, "
          f"{report['tokens_per_sec']:.1f} tokens/s, K1 {launches[0]} + {launches[1]}, K2 "
          f"{launches[2]} + {launches[3]} in {steps} steps; roofline of one profiled step: "
          f"device {r['device_ms']:.3f} ms against the profile's busy {r['summary_busy_ms']:.3f} "
          f"ms (wall {r['summary_wall_ms']:.3f}), {r['traffic_gb']:.3f} GB, HBM bound "
          f"{r['hbm_bound_ms']:.3f} ms ({r['hbm_efficiency']:.1%} of peak on average), "
          f"tensor-core bound {r['tensor_core_bound_ms']:.3f} ms, claw-back "
          f"{r['clawback_ms']:.3f} ms; K1 forward {r['k1_forward']['ms']:.4f} ms at "
          f"{r['k1_forward']['of_hbm_peak']:.1%} of the HBM peak; K2 {r['k2_forward']['ms']:.3f}"
          f" + {r['k2_backward']['ms']:.3f} ms; {result['phase_seconds']:.1f} s; on {card}",
          flush=True)
    return result


# ---------------------------------------------------------------------------
# Phase 36: the GPU cluster plane, both modes in a stub world, its smoke
# commands and the compiled gke-gpu LM Job on the card

# the cloud's tools for an H100 deployment of one host with one GPU
GPU_PLANE_STUBS = {
    **PROVISION_STUBS,
    "terraform": """#!/bin/sh
echo "terraform $* in $(basename "$PWD")" >> "$CALLS_LOG"
case "$1" in
  apply) echo '{"resources": [{"type": "gpu"}]}' > terraform.tfstate ;;
  output) echo '{"host_ips": {"value": [["10.0.0.1"]]}, "internal_ips": {"value": [["10.1.0.1"]]}}' ;;
  destroy) rm -f terraform.tfstate ;;
esac
""",
    "gcloud": """#!/bin/sh
echo "gcloud $*" >> "$CALLS_LOG"
case "$*" in
  "config get-value project") echo smoke-proj ;;
  "config get-value account") echo smoke@stub.test ;;
  *"instances list"*) printf "${GPU_LISTING:-gpunode-0-0\\tRUNNING\\n}" ;;
esac
""",
    "kubectl": """#!/bin/sh
echo "kubectl $*" >> "$CALLS_LOG"
case "$*" in
  "get job gpu-probe -o json")
    echo '{"spec": {"completions": 1}, "status": {"conditions": [{"type": "Complete", "status": "True"}]}}' ;;
  *)
    echo '{"items": [{"metadata": {"name": "n1"}, "status": {"allocatable": {"nvidia.com/gpu": "1"}, "conditions": [{"type": "Ready", "status": "True"}]}}]}' ;;
esac
""",
}
# the GPU wizard's answers (project, env name, env description, cluster name,
# node prefix, mode, family, topology, slices, zone, network, subnetwork):
# h100, 1x1 (one host, one GPU), one slice, the catalog's first zone
GPU_PLANE_ANSWERS = {"gke-gpu": ["", "", "", "", "", "1", "", "1", "", "", "", "", "yes"],
                     "gpu-vm": ["", "", "", "", "", "2", "", "1", "", "", "", "", "yes"]}
# what no GPU document may name (the ConfigMap's base64 archive aside)
TPU_STRINGS = ("jax", "libtpu", "JAX_", "TPU_", "google.com/tpu", "gke-tpu")
GPU_SMOKE_TIMEOUT_S = 300
# the refusal of `heal` on a GKE deployment, gke-gpu's as gke's: its node
# pools self-repair (tests/test_torch_gpu_plane.py holds it to the JAX
# package's message)
GKE_HEAL_REFUSAL = ("heal repairs standalone TPU VM slices; GKE node pools self-repair "
                    "(auto_repair) and gang-restart via the Job backoff budget — see "
                    "docs/failure-modes.md")


def _no_tpu_strings(where: str, text: str) -> None:
    found = [word for word in TPU_STRINGS if word in text]
    if found:
        raise AssertionError(f"{where} names {found}")


def _no_tpu_words(where: str, text: str) -> None:
    """What a gpu-vm heal or supervise prints names no TPU either."""
    _no_tpu_strings(where, text)
    if "TPU" in text or "tpu-vm" in text:
        raise AssertionError(f"{where} names a TPU: {text[-3000:]}")


def heal_gpu_plane(mode: str, work: pathlib.Path, config, calls_log: pathlib.Path,
                   out: dict) -> dict:
    """The provisioned deployment's heal and supervise in the stub world.
    gke-gpu: `heal` exits 1 with the gke refusal. gpu-vm: the listing
    reports host `gpunode-0-0` TERMINATED (a host maintenance event
    stopped it); `heal` replaces its instance, reconverges it with the GPU
    playbook and rewrites the ansible vars, whose smoke commands phase 36
    then runs (`out["vars"]`); `supervise --ticks 2` over the restored
    listing finds every slice healthy. Returns seconds and stub calls."""
    paths = RunPaths(work)
    started = time.monotonic()
    rc, text, err, calls = _cli(["heal", "--workdir", str(work)], [], calls_log)
    heal_s = time.monotonic() - started
    if mode == "gke-gpu":
        if rc != 1 or not err.endswith(f"ERROR: {GKE_HEAL_REFUSAL}\n") or calls:
            raise AssertionError(f"heal of gke-gpu exited {rc}, calls {calls}: {err[-2000:]}")
        return {"heal_seconds": heal_s, "heal_exit": rc}
    os.environ["GPU_LISTING"] = "gpunode-0-0\\tTERMINATED\\n"
    try:
        started = time.monotonic()
        rc, text, err, calls = _cli(["heal", "--workdir", str(work)], [], calls_log)
        heal_s = time.monotonic() - started
    finally:
        del os.environ["GPU_LISTING"]
    group_vars = yaml.safe_load((paths.ansible_dir / "group_vars" / "all.yml").read_text())
    expected = ["terraform apply -auto-approve -input=false -no-color -lock-timeout=600s "
                "-replace=google_compute_instance.host[0] in gpu-vm",
                "terraform output -json in gpu-vm",
                "ansible-playbook -i hosts clusterUpGpu.yml --limit 10.0.0.1"]
    if (rc != 0 or [c for c in calls if c.startswith(("terraform apply", "terraform output",
                                                       "ansible"))] != expected
            or "slice 0: unready (host VM status gpunode-0-0 TERMINATED (want RUNNING))"
            not in text or "Healed slice(s) 0; fleet fully healthy." not in text
            or group_vars != compiler.to_ansible_vars(config, "10.1.0.1")):
        raise AssertionError(f"heal of gpu-vm exited {rc}, calls {calls}, vars {group_vars}: "
                             f"{text[-3000:]} {err[-3000:]}")
    _no_tpu_words("gpu-vm heal", text + err)
    out["vars"] = group_vars  # the healed deployment's smoke commands
    heal_calls = len(calls)
    started = time.monotonic()
    rc, text, err, calls = _cli(["supervise", "--ticks", "2", "--interval", "0",
                                 "--workdir", str(work)], [], calls_log)
    supervise_s = time.monotonic() - started
    status = json.loads(paths.fleet_status.read_text()) if paths.fleet_status.exists() else {}
    if (rc != 0 or status.get("verdict") != "healthy"
            or status.get("slice_states") != {"healthy": 1}
            or any(c.startswith(("terraform", "ansible")) for c in calls)):
        raise AssertionError(f"supervise of gpu-vm exited {rc}, status {status}, calls {calls}: "
                             f"{text[-3000:]} {err[-3000:]}")
    _no_tpu_words("gpu-vm supervise", text + err)
    return {"heal_seconds": heal_s, "heal_calls": heal_calls,
            "supervise_seconds": supervise_s, "supervise_calls": len(calls)}


def provision_gpu_plane(root: pathlib.Path) -> dict:
    """Phase 36's provisioning half: `cli.main --accelerator gpu` through
    the wizard for gke-gpu (with --probe) and gpu-vm in a stub world, the
    documents each wrote, the heal and supervise of each
    (`heal_gpu_plane`), then `-c --yes`. Returns the documents phase 36
    runs on the card."""
    out: dict = {"seconds": {}, "calls": {}, "heal": {}}
    flags = " ".join(SHIPPED_FLAGS["lm"])
    with _stub_world(root, GPU_PLANE_STUBS):
        for mode, answers in GPU_PLANE_ANSWERS.items():
            work = root / mode
            (work / "ansible").mkdir(parents=True)
            (work / "ansible" / "ansible.cfg").write_text(
                "[defaults]\nhost_key_checking = False\nprivate_key_file =\n")
            paths = RunPaths(work)
            calls_log = root / "calls.log"
            argv = ["--accelerator", "gpu", "--workdir", str(work), "--bench-workload", "lm",
                    "--bench-flags", flags] + (["--probe"] if mode == "gke-gpu" else [])
            started = time.monotonic()
            rc, text, err, calls = _cli(argv, answers, calls_log)
            out["seconds"][mode] = time.monotonic() - started
            config = store_lib.load_config_file(paths.config_file) if paths.config_file.exists() \
                else None
            playbook = ("ansible-playbook -i hosts clusterUpGpu.yml" if mode == "gke-gpu" else
                        "ansible-playbook -i hosts clusterUpGpu.yml --limit 10.0.0.1")
            if (rc != 0 or "Cluster is ready" not in text or config is None
                    or (config.mode, config.generation, config.topology) != (mode, "h100", "1x1")
                    or f"terraform apply -auto-approve -input=false -no-color in {mode}"
                    not in calls or playbook not in calls):
                raise AssertionError(f"--accelerator gpu provisioned {mode}: exit {rc}, calls "
                                     f"{calls}: {text[-3000:]} {err[-3000:]}")
            tfvars = json.loads(paths.tfvars(mode).read_text())
            group_vars = yaml.safe_load((paths.ansible_dir / "group_vars" / "all.yml").read_text())
            if (tfvars != compiler.to_tfvars(config)
                    or group_vars != compiler.to_ansible_vars(
                        config, "10.1.0.1" if mode == "gpu-vm" else "")):
                raise AssertionError(f"{mode}: tfvars {tfvars}, vars {group_vars}")
            documents = {"tfvars": json.dumps(tfvars), "vars": json.dumps(group_vars),
                         "inventory": paths.inventory.read_text()}
            if mode == "gke-gpu":
                docs = {p.name: yaml.safe_load(p.read_text())
                        for d in (paths.manifests_dir, paths.probe_dir)
                        for p in sorted(d.glob("*.yaml"))}
                configmap = docs.pop("package-configmap.yaml")
                out["archive"] = base64.b64decode(configmap["binaryData"][packaging.ARCHIVE_NAME])
                out["job"], out["probe"] = docs["bench-job-0.yaml"], docs["gpu-probe.yaml"]
                documents.update({name: json.dumps(doc) for name, doc in docs.items()})
                if (sorted(docs) != ["bench-job-0.yaml", "bench-service.yaml", "gpu-probe.yaml"]
                        or "kubectl get nodes -o json" not in calls):
                    raise AssertionError(f"gke-gpu documents {sorted(docs)}, calls {calls}")
            else:
                out["vars"] = group_vars
                if "[GPUHOST]" not in documents["inventory"] or not any(
                        c.startswith("gcloud compute instances list") for c in calls):
                    raise AssertionError(f"gpu-vm inventory {documents['inventory']}, calls {calls}")
            for name, text_doc in documents.items():
                _no_tpu_strings(f"{mode} {name}", text_doc)
            out["calls"][mode] = len(calls)
            out["heal"][mode] = heal_gpu_plane(mode, work, config, calls_log, out)

            cleaned = _cli(["-c", "--yes", "--workdir", str(work)], [], calls_log)
            left = [p for p in (paths.config_file, paths.hosts_file, paths.tfstate(mode),
                                paths.manifests_dir, paths.ansible_dir / "roles" / "gpuhost" /
                                "files") if p.exists()]
            if (cleaned[0] != 0 or left
                    or f"terraform destroy -auto-approve -input=false -no-color in {mode}"
                    not in cleaned[3]):
                raise AssertionError(f"-c --yes on {mode} exited {cleaned[0]}, left {left}, "
                                     f"calls {cleaned[3]}: {cleaned[1][-2000:]}")
    return out


def _smoke(command: str, env: dict, ok: str) -> tuple[float, str]:
    """A smoke command as a host runs it: (its seconds, its OK line)."""
    started = time.monotonic()
    done = subprocess.run(["bash", "-c", command], env=env, capture_output=True, text=True,
                          timeout=GPU_SMOKE_TIMEOUT_S)
    seconds = time.monotonic() - started
    lines = [line for line in done.stdout.splitlines() if line.startswith(ok)]
    if done.returncode or len(lines) != 1:
        raise AssertionError(f"`{command}` exited {done.returncode}: {done.stdout[-2000:]} "
                             f"{done.stderr[-3000:]}")
    return seconds, lines[0]


def run_gpu_plane(card: str) -> dict:
    """Phase 36: the GPU cluster plane provisioned through the wizard in a
    stub world, then on the card, from the archive the gke-gpu ConfigMap
    carries (installed offline, as phase 32 does): the probe Job's smoke,
    the gpu-vm vars' smoke and NCCL cluster smoke at a world of one, and
    the compiled gke-gpu LM Job's launcher command with K1 and K2 built
    from the installed sources and counted."""
    started = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        plane = provision_gpu_plane(root)
        archive = root / packaging.ARCHIVE_NAME
        archive.write_bytes(plane["archive"])
        site = root / "site"
        install_started = time.monotonic()
        pip = subprocess.run(
            [sys.executable, "-m", "pip", "install", "--quiet", "--no-index",
             "--disable-pip-version-check", "--no-build-isolation", "--no-deps", "--target",
             str(site), str(archive)], capture_output=True, text=True, timeout=300)
        install_s = time.monotonic() - install_started
        if pip.returncode:
            raise AssertionError(f"pip install exited {pip.returncode}: {pip.stderr[-3000:]}")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = str(site)

        install, probe_smoke = plane["probe"]["spec"]["template"]["spec"]["containers"][0][
            "command"][-1].split(" && ")
        if probe_smoke != compiler.gpu_smoke_command(1) or not install.startswith("pip install"):
            raise AssertionError(f"the probe Job's command: {install} && {probe_smoke}")
        probe_s, probe_line = _smoke(probe_smoke, env, "GPU OK: 1 devices")
        # the gpu-vm host's smoke is the probe's command byte for byte (one
        # GPU a host on both 1x1 slices): the probe's run on this host is its
        # run, so it is not started a second time
        if plane["vars"]["gpu_smoke_cmd"] != probe_smoke:
            raise AssertionError(f"the gpu-vm vars' smoke {plane['vars']['gpu_smoke_cmd']!r} is "
                                 f"not the probe Job's {probe_smoke!r}")
        host_s, host_line = probe_s, probe_line
        cluster_cmd = (plane["vars"]["cluster_smoke_cmd"].replace("{{ node_rank }}", "0")
                       .replace("{{ global_coordinator }}", "127.0.0.1"))
        cluster_s, cluster_line = _smoke(cluster_cmd, env, "CLUSTER OK: 1 processes, 1 GPUs")

        job = plane["job"]
        container = job["spec"]["template"]["spec"]["containers"][0]
        svc = f"{job['metadata']['name']}-0.{job['spec']['template']['spec']['subdomain']}"
        install, launch = container["command"][-1].split(" && ")
        module = "tritonk8ssupervisor_tpu_torch.benchmarks.lm"
        child = root / "child.py"
        child.write_text(SHIPPED_CHILD)
        counted = launch.replace(svc, "127.0.0.1").replace(f"-m {module}", f"{child} {module}")
        if (counted.count("127.0.0.1") != 1 or str(child) not in counted
                or not launch.startswith("python -m torch.distributed.run --nnodes 1 "
                                         "--nproc-per-node 1 --node-rank $JOB_COMPLETION_INDEX")):
            raise AssertionError(f"the gke-gpu LM Job's command: {launch}")
        counts_file = root / "counts.json"
        job_env = {**env, "JOB_COMPLETION_INDEX": "0", "TK8S_SMOKE_COUNTS": str(counts_file),
                   **{e["name"]: e["value"].replace(svc, "127.0.0.1") for e in container["env"]}}
        launched_at = time.time()
        run = subprocess.run(["bash", "-c", counted], env=job_env, cwd=root,
                             capture_output=True, text=True, timeout=SHIPPED_RUN_TIMEOUT_S)
        run_s = time.time() - launched_at
        if run.returncode:
            raise AssertionError(f"the gke-gpu LM Job exited {run.returncode}: "
                                 f"{run.stderr[-3000:]}")
        report = json.loads(run.stdout.strip().splitlines()[-1])
        counts = json.loads(counts_file.read_text())
        steps, layers = report["final_step"], report.get("num_layers")
        launches = (counts["k1"], counts["k1_backward"], counts["k2_forward"],
                    counts["k2_backward"])
        csrc = site / "tritonk8ssupervisor_tpu_torch" / "csrc"
        if (report["platform"] != "gpu" or not math.isfinite(report["final_loss"])
                or (layers, report.get("seq_len"), report.get("embed_dim"),
                    report.get("global_batch")) != (12, 1024, 768, 8)
                or not counts["package"].startswith(str(site))
                or set(counts["build_seconds"]) != {K1_SOURCE, K2_SOURCE}
                or any(pathlib.Path(counts["libraries"][s]).parent != csrc / "build"
                       for s in (K1_SOURCE, K2_SOURCE))
                or not steps or launches != (steps, steps, layers * steps, layers * steps)):
            raise AssertionError(f"the gke-gpu LM Job: launches {launches} in {steps} steps, "
                                 f"counts {counts}, report {report}")
    result = {
        "provision_seconds": plane["seconds"], "stub_calls": plane["calls"],
        "heal": plane["heal"],
        "install_seconds": install_s, "probe_smoke_seconds": probe_s, "probe_line": probe_line,
        "host_smoke_seconds": host_s, "host_line": host_line,
        "cluster_smoke_seconds": cluster_s, "cluster_line": cluster_line,
        "lm_job": {"command": counted, "step_ms": report["step_ms"],
                   "step_ms_windows": report.get("step_ms_windows"),
                   "tokens_per_sec": report["tokens_per_sec"], "final_step": steps,
                   "launcher_startup_seconds": counts["started_at"] - launched_at,
                   "build_seconds": counts["build_seconds"], "run_seconds": run_s},
        "launches": {"k1": launches[0], "k1_backward": launches[1], "k2_forward": launches[2],
                     "k2_backward": launches[3]},
        "phase_seconds": time.monotonic() - started,
    }
    lm = result["lm_job"]
    healed = plane["heal"]["gpu-vm"]
    print("gpu plane: " + json.dumps(result, sort_keys=True, default=str), flush=True)
    print(f"gpu plane (phase 36): provisioned gke-gpu and gpu-vm (h100 1x1) through the wizard "
          f"in {plane['seconds']['gke-gpu']:.2f} + {plane['seconds']['gpu-vm']:.2f} s of stub "
          f"calls; healed the gpu-vm host TERMINATED by a maintenance event in "
          f"{healed['heal_seconds']:.2f} s ({healed['heal_calls']} stub calls) and supervised "
          f"it healthy in {healed['supervise_seconds']:.2f} s ({healed['supervise_calls']} stub "
          f"calls); gke-gpu heal refused in {plane['heal']['gke-gpu']['heal_seconds']:.2f} s; "
          f"cleaned; pip install {install_s:.1f} s; probe smoke {probe_s:.1f} s ({host_line}; "
          f"the host smoke is the same command), NCCL cluster smoke {cluster_s:.1f} s "
          f"({cluster_line}); the gke-gpu LM Job under the launcher, 12L/768/seq 1024/batch 8: "
          f"launcher start-up {lm['launcher_startup_seconds']:.2f} s, nvcc "
          + ", ".join(f"{k} {v:.1f} s" for k, v in lm["build_seconds"].items())
          + f", step {lm['step_ms']:.2f} ms, {lm['tokens_per_sec']:.1f} tokens/s, K1 "
          f"{launches[0]} + {launches[1]}, K2 {launches[2]} + {launches[3]} in {steps} steps, "
          f"run {run_s:.1f} s; {result['phase_seconds']:.1f} s; on {card}", flush=True)
    return result


# Phase 37: K2 at every head_dim up to 256 and K3 at any head_dim (faults
# F10 and F11), and the LM at its published widths with 8 and 3 heads
# (head_dim 96 and 256) through K2

# K2's shapes: (b, s, h, d, causal, layout, dtype)
HEAD_DIM_K2 = [
    (8, 1024, 8, 96, True, "bshd", torch.bfloat16),   # benchmarks.lm --num-heads 8
    (8, 1024, 24, 32, True, "bshd", torch.bfloat16),  # --num-heads 24
    (8, 1024, 3, 256, True, "bshd", torch.bfloat16),  # --num-heads 3
    (8, 1024, 32, 80, True, "bshd", torch.bfloat16),  # Phi-2's 32 heads of 80
    (2, 1000, 4, 40, False, "bshd", torch.bfloat16),  # ragged; columns 40-63 read as zeros
    (2, 1000, 4, 36, False, "bshd", torch.bfloat16),  # not a multiple of 8: the padded copy
    (2, 512, 2, 256, False, "bhsd", torch.float16),
]
# timed calls of the kernel and SDPA, and of the plain version, at each
HEAD_DIM_K2_ITERS = (30, 6)
# K3's: (label, b, w, h, length, d, pos, layout); an inactive slot (-1)
# reads all L
HEAD_DIM_K3 = [
    ("head_dim 40, pos 639", 8, 1, 4, 640, 40, 639, "blhd"),
    ("head_dim 40, paged engine decode", 4, 1, 4, 512, 40, [300, 511, 17, -1], "paged"),
    ("head_dim 72, pos 639", 8, 1, 8, 640, 72, 639, "blhd"),
    ("head_dim 72, paged 5-query verify", 4, 5, 8, 512, 72,
     [[p + i for i in range(5)] for p in (300, 507, 17, 0)], "paged"),
    ("head_dim 256, pos 639", 8, 1, 3, 640, 256, 639, "bhld"),
]
HEAD_DIM_LM_HEADS = (8, 3)  # head_dim 96 and 256 at embed 768
HEAD_DIM_LM_STEPS = dict(steps=3, warmup=1, windows=1)


def _lm_first_update(num_heads: int, attention_fn) -> tuple[float, torch.Tensor]:
    """The first step of `benchmarks.lm.run_benchmark` at `num_heads`, from
    its weights (the seed-0 generator), optimizer and tokens, with
    `attention_fn`: (its loss, the update of every parameter, flat)."""
    model = TransformerLM(vocab_size=32768, num_layers=12, num_heads=num_heads, embed_dim=768,
                          max_seq_len=1024, attention_fn=attention_fn)
    state = train.create_train_state(model, train.default_optimizer(MESH_LR["lm"]), "cuda")
    step = train.make_lm_train_step(state)
    before = torch.cat([p.detach().flatten() for p in state.model.parameters()])
    loss = step(_lm_tokens())["loss"].item()
    return loss, torch.cat([p.detach().flatten() for p in state.model.parameters()]) - before


def run_lm_heads(card: str, num_heads: int) -> dict:
    """`benchmarks.lm.run_benchmark` at the published widths with
    `num_heads` heads, attention "auto" (K2 on the card), after its first
    step against the same step with dense attention: the loss to
    PARITY_LOSS_ATOL, the update to VIT_UPDATE_REL (dense attention rounds
    its scores to bf16 where K2 keeps them in f32). K2 must launch 12 + 12
    times a step and copy nothing."""
    first = {name: _lm_first_update(num_heads, fn)
             for name, fn in (("flash", fa.flash_attention), ("dense", dense_attention))}
    rel = ((first["flash"][1] - first["dense"][1]).norm() / first["dense"][1].norm()).item()
    diff = abs(first["flash"][0] - first["dense"][0])
    losses = {name: first[name][0] for name in first}
    del first
    counters = _k1_k2_counters()
    for counter in counters:
        counter.launches = 0
    fa.flash_attention_forward.copies = 0
    result = lm_bench.run_benchmark(num_heads=num_heads, attention="auto", **HEAD_DIM_LM_STEPS)
    k1, k1_bwd, k2_fwd, k2_bwd = (c.launches for c in counters)
    copies = fa.flash_attention_forward.copies
    steps, layers = result["final_step"], result["num_layers"]
    d = 768 // num_heads
    print(f"LM 12L/768/seq 1024/batch 8 with {num_heads} heads of {d} (attention auto = "
          f"{result['attention']}): first step loss flash {losses['flash']:.6f} dense "
          f"{losses['dense']:.6f}, |diff| {diff:.2e} (tolerance {PARITY_LOSS_ATOL}), first update "
          f"|d_flash - d_dense| / |d_dense| {rel:.2e} (tolerance {VIT_UPDATE_REL}); step "
          f"{result['step_ms']:.2f} ms, {result['tokens_per_sec']:.1f} tokens/s, final loss "
          f"{result['final_loss']:.6f}, launches in {steps} steps: K1 {k1} + {k1_bwd}, K2 "
          f"{k2_fwd} + {k2_bwd}, K2 input copies {copies}, on {card}", flush=True)
    if not (diff <= PARITY_LOSS_ATOL and rel <= VIT_UPDATE_REL):
        raise AssertionError(f"LM at head_dim {d}: flash and dense attention disagree")
    if (result["platform"] != "gpu" or result["attention"] != "flash"
            or not math.isfinite(result["final_loss"])):
        raise AssertionError(f"LM at head_dim {d}: {result}")
    if (k1, k1_bwd, k2_fwd, k2_bwd, copies) != (steps, steps, layers * steps, layers * steps, 0):
        raise AssertionError(f"LM at head_dim {d}: {steps} steps launched K1 {k1} + {k1_bwd}, "
                             f"K2 {k2_fwd} + {k2_bwd}, {copies} K2 input copies")
    return {"num_heads": num_heads, "head_dim": d, "first_step_loss": losses,
            "first_update_rel": rel, "step_ms": result["step_ms"],
            "tokens_per_sec": result["tokens_per_sec"], "final_step": steps,
            "final_loss": result["final_loss"], "k1": k1, "k1_backward": k1_bwd,
            "k2_forward": k2_fwd, "k2_backward": k2_bwd, "k2_copies": copies}


def run_head_dims(card: str) -> dict:
    """Phase 37: K2 against its plain version at the head_dims of the LM's
    other head counts, Phi-2's, a ragged and a padded width and fp16 at
    256; K3 at head_dim 40, 72 and 256; the LM benchmark at 8 and 3 heads
    through K2; the int8-cache `generate` of a 2-layer LM with 4 heads of
    40, token-equal to the CPU."""
    started = time.monotonic()
    iters, plain_iters = HEAD_DIM_K2_ITERS
    k2_rows = [check_k2(b, s, h, d, causal, layout, dtype=dtype, seed=40 + i, iters=iters,
                        plain_iters=plain_iters)
               for i, (b, s, h, d, causal, layout, dtype) in enumerate(HEAD_DIM_K2)]
    _print_k2(k2_rows, card)
    k3_rows = [check_k3(label, b, w, h, length, d, pos, layout=layout, seed=40 + i)
               for i, (label, b, w, h, length, d, pos, layout) in enumerate(HEAD_DIM_K3)]
    _print_k3(k3_rows, card)
    lm = {heads: run_lm_heads(card, heads) for heads in HEAD_DIM_LM_HEADS}
    k3_generate = check_decode_parity(num_heads=4, embed_dim=160, dtypes=(torch.float32,))
    result = {"k2": k2_rows, "k3": k3_rows, "lm": lm, "generate_k3": k3_generate,
              "phase_seconds": time.monotonic() - started}
    print("head dims: " + json.dumps(result, sort_keys=True, default=str), flush=True)
    print(f"head dims (phase 37): K2 at head_dim "
          f"{sorted({r['shape'][-1] for r in k2_rows})} and K3 at "
          f"{sorted({r['shape'][-1] for r in k3_rows})} against their plain versions; the LM "
          + ", ".join(f"at {r['num_heads']} heads of {r['head_dim']}: step {r['step_ms']:.2f} ms, "
                      f"K2 {r['k2_forward']} + {r['k2_backward']} in {r['final_step']} steps"
                      for r in lm.values())
          + f"; generate at 4 heads of 40, K3 {k3_generate} launches, tokens equal to the CPU; "
          f"{result['phase_seconds']:.1f} s; on {card}", flush=True)
    return result


# Phase 38: K2 and K4 at every dtype and width the reference takes (F12,
# F13, F14): K2's 3xTF32 and K4's TF32 instances against float64 and their
# plain versions, the f32 LM and the f32 fused ResNet-50 stepped through
# them

# K2's f32 shapes: (b, s, h, d, causal, layout)
F32_K2 = [
    (8, 1024, 12, 64, True, "bshd"),   # the LM
    (8, 1024, 8, 96, True, "bshd"),    # the LM with --num-heads 8
    (8, 1024, 3, 256, True, "bshd"),   # the LM with --num-heads 3
    (256, 197, 6, 64, False, "bshd"),  # ViT-S/16's attention
    (2, 1000, 4, 40, True, "bhsd"),    # ragged, head-major
]
# timed calls of the kernel and SDPA, and of the plain version, at each
F32_K2_ITERS = (20, 3)
# bf16 rows at widths that are not multiples of 8 (the TF32 instance's
# one-product route, "tf32x1"):
# (spatial size at batch 256, C, N)
F32_K4_NARROW = [(14, 3, 13), (4, 100, 36)]
F32_LM_STEPS = 3
F32_RESNET_STEPS = 3
F32_RESNET_BATCH = 256
# the first step of the f32 LM through K2's 3xTF32 instance against the same
# step with dense attention (the f32 plain version), and of the f32 fused
# ResNet-50 through K4's against the default path (cuDNN, TF32 off): the
# loss to 1e-5 relative, the first SGD update to 1e-3 of its largest entry
# (f32 sums in other orders, through 12 layers or 53 convolutions)
F32_LOSS_REL = 1e-5
F32_UPDATE_REL = 1e-3


def _f32_steps(make_model, make_step, lr: float, batch: tuple, steps: int) -> dict:
    """`steps` SGD steps at `lr` of a fresh f32 model on `batch`: its
    losses, its first update (every parameter, flat) and the mean step ms
    of the steps after the first (host clock, fenced by reading the loss)."""
    state = train.create_train_state(make_model(), train.default_optimizer(lr), "cuda")
    step = make_step(state)
    before = torch.cat([p.detach().flatten() for p in state.model.parameters()])
    losses, times = [step(*batch)["loss"].item()], []
    update = torch.cat([p.detach().flatten() for p in state.model.parameters()]) - before
    del before
    for _ in range(steps - 1):
        started = time.perf_counter()
        losses.append(step(*batch)["loss"].item())
        times.append((time.perf_counter() - started) * 1e3)
    del state, step
    return {"losses": losses, "update": update, "step_ms": statistics.mean(times)}


def _first_steps_agree(what: str, ours: dict, ref: dict) -> dict:
    loss_rel = abs(ours["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    update_rel = ((ours["update"] - ref["update"]).abs().max()
                  / ref["update"].abs().max()).item()
    if not (loss_rel <= F32_LOSS_REL and update_rel <= F32_UPDATE_REL
            and all(math.isfinite(x) for x in ours["losses"] + ref["losses"])):
        raise AssertionError(f"{what}: first-step loss {loss_rel:.2e} (tolerance {F32_LOSS_REL}), "
                             f"first update {update_rel:.2e} (tolerance {F32_UPDATE_REL}), "
                             f"losses {ours['losses']} against {ref['losses']}")
    return {"first_step_loss_rel": loss_rel, "first_update_rel": update_rel}


def run_f32_lm(card: str) -> dict:
    """The LM at its published widths in f32 (`dtype = logits_dtype =
    float32`) with `flash_attention`: F32_LM_STEPS steps through K2's
    3xTF32 instance and K1 on f32 logits, then as many from the same
    weights with dense attention. K2 must launch 12 + 12 times a step, all
    on the 3xTF32 instance, and K1 1 + 1."""
    def model(attention_fn):
        return lambda: TransformerLM(vocab_size=32768, num_layers=12, num_heads=12,
                                     embed_dim=768, max_seq_len=1024, attention_fn=attention_fn,
                                     dtype=torch.float32, logits_dtype=torch.float32)

    counters = _k1_k2_counters()
    for counter in counters:
        counter.launches = 0
    fa.flash_attention_forward.tf32_launches = fa.flash_attention_backward.tf32_launches = 0
    fa.flash_attention_forward.copies = 0
    flash = _f32_steps(model(fa.flash_attention), train.make_lm_train_step, MESH_LR["lm"],
                       (_lm_tokens(),), F32_LM_STEPS)
    launches = [c.launches for c in counters]
    tf32 = [fa.flash_attention_forward.tf32_launches, fa.flash_attention_backward.tf32_launches]
    copies = fa.flash_attention_forward.copies
    dense = _f32_steps(model(dense_attention), train.make_lm_train_step, MESH_LR["lm"],
                       (_lm_tokens(),), F32_LM_STEPS)
    agree = _first_steps_agree("the f32 LM, flash against dense attention", flash, dense)
    steps = F32_LM_STEPS
    if (launches != [steps, steps, 12 * steps, 12 * steps] or tf32 != launches[2:]
            or copies != 0):
        raise AssertionError(f"the f32 LM: {steps} steps launched K1 {launches[:2]}, K2 "
                             f"{launches[2:]} ({tf32} on the 3xTF32 instance), {copies} copies")
    result = {**agree, "losses": {"flash": flash["losses"], "dense": dense["losses"]},
              "step_ms": {"flash": flash["step_ms"], "dense": dense["step_ms"]}, "steps": steps,
              "k1": launches[0], "k1_backward": launches[1], "k2_forward": launches[2],
              "k2_backward": launches[3], "k2_tf32": tf32, "k2_copies": copies}
    print(f"f32 LM 12L/768/seq 1024/batch 8, flash_attention (K2's 3xTF32 instance) against dense "
          f"attention from one set of weights: first-step loss {flash['losses'][0]:.6f} against "
          f"{dense['losses'][0]:.6f} (rel {agree['first_step_loss_rel']:.2e}, tolerance "
          f"{F32_LOSS_REL}), first update within {agree['first_update_rel']:.2e} of its largest "
          f"entry (tolerance {F32_UPDATE_REL}); step {flash['step_ms']:.2f} ms against dense "
          f"{dense['step_ms']:.2f} ms; launches in {steps} steps: K1 {launches[0]} + "
          f"{launches[1]}, K2 {launches[2]} + {launches[3]} ({tf32[0]} + {tf32[1]} 3xTF32), "
          f"{copies} copies, on {card}", flush=True)
    return result


def run_f32_resnet50(card: str) -> dict:
    """ResNet-50 at batch 256, 224x224, in f32 with `fused_1x1_bwd` (K4's
    TF32 instance, "tf32x3", for its 33 stride-1 1x1 convolutions a step) against the
    default path (cuDNN, TF32 off), from one set of weights and batch."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn((F32_RESNET_BATCH, 224, 224, 3), generator=gen, device="cuda")
    labels = torch.randint(0, 1000, (F32_RESNET_BATCH,), generator=gen, device="cuda",
                           dtype=torch.int32)
    k4 = cb.conv1x1_backward_kernel
    k4.launches = k4.tf32_launches = 0
    cb.conv1x1_backward.copies = 0
    torch.cuda.reset_peak_memory_stats()
    fused = _f32_steps(lambda: ResNet50(num_classes=1000, dtype=torch.float32,
                                        fused_1x1_bwd=True),
                       train.make_train_step, MESH_LR["resnet50"], (images, labels),
                       F32_RESNET_STEPS)
    peak = torch.cuda.max_memory_allocated()
    launches, tf32, copies = k4.launches, k4.tf32_launches, cb.conv1x1_backward.copies
    default = _f32_steps(lambda: ResNet50(num_classes=1000, dtype=torch.float32),
                         train.make_train_step, MESH_LR["resnet50"], (images, labels),
                         F32_RESNET_STEPS)
    agree = _first_steps_agree("the f32 ResNet-50, fused_1x1_bwd against the default path",
                               fused, default)
    per_step = sum(calls for *_, calls in K4_SHAPES)
    if (launches, tf32) != (per_step * F32_RESNET_STEPS,) * 2 or copies:
        raise AssertionError(f"the f32 fused ResNet-50: K4 launched {launches} times ({tf32} "
                             f"on the TF32 instance), {copies} copies in {F32_RESNET_STEPS} steps")
    result = {**agree, "losses": {"fused": fused["losses"], "default": default["losses"]},
              "step_ms": {"fused": fused["step_ms"], "default": default["step_ms"]},
              "steps": F32_RESNET_STEPS, "batch": F32_RESNET_BATCH, "k4": launches,
              "k4_tf32": tf32, "k4_copies": copies, "peak_memory_bytes": peak}
    print(f"f32 ResNet-50 batch {F32_RESNET_BATCH} 224x224, fused_1x1_bwd (K4's 3xTF32 route) "
          f"against the default path (cuDNN, TF32 off) from one set of weights: first-step loss "
          f"{fused['losses'][0]:.6f} against {default['losses'][0]:.6f} (rel "
          f"{agree['first_step_loss_rel']:.2e}), first update within "
          f"{agree['first_update_rel']:.2e} of its largest entry; step {fused['step_ms']:.2f} ms "
          f"against {default['step_ms']:.2f} ms; K4 {launches} launches ({tf32} TF32) in "
          f"{F32_RESNET_STEPS} steps; peak memory {peak / 1e9:.2f} GB; on {card}", flush=True)
    return result


def run_f32(card: str) -> dict:
    """Phase 38: K2's 3xTF32 instance against float64 and its plain version at
    the LM's, its 8- and 3-head, ViT-S/16's and a ragged head-major shape,
    timed beside SDPA in f32; K4's at ResNet-50's 12 shapes in f32 and two
    bf16 shapes of widths that are not multiples of 8, timed beside cuDNN;
    the f32 LM and the f32 fused ResNet-50 stepped through them."""
    started = time.monotonic()
    iters, plain_iters = F32_K2_ITERS
    k2_rows = [check_k2(b, s, h, d, causal, layout, dtype=torch.float32, seed=60 + i,
                        iters=iters, plain_iters=plain_iters)
               for i, (b, s, h, d, causal, layout) in enumerate(F32_K2)]
    _print_k2(k2_rows, card)
    k4_rows = [check_k4(size, c, n, calls, seed=60 + i, dtype=torch.float32, by_kernel=False)
               for i, (size, c, n, calls) in enumerate(K4_SHAPES)]
    k4_rows += [check_k4(size, c, n, 0, seed=80 + i, dtype=torch.bfloat16, by_kernel=False)
                for i, (size, c, n) in enumerate(F32_K4_NARROW)]
    _print_k4(k4_rows, card)
    k4_step = _k4_step(k4_rows[:len(K4_SHAPES)])
    print("K4 f32 per ResNet-50 step (sum of calls x device time): " + ", ".join(
        f"{k} {'not measured' if v is None else f'{v:.4f}'}" for k, v in k4_step.items())
        + f" (library_ratio: kernel / cuDNN in f32) on {card}", flush=True)
    lm = run_f32_lm(card)
    resnet50 = run_f32_resnet50(card)
    result = {"k2": k2_rows, "k4": k4_rows, "k4_per_step": k4_step, "lm": lm,
              "resnet50": resnet50, "phase_seconds": time.monotonic() - started}
    print("f32: " + json.dumps(result, sort_keys=True, default=str), flush=True)
    print(f"f32 (phase 38): K2's 3xTF32 instance at {[r['shape'] for r in k2_rows]} and K4's at "
          f"ResNet-50's 12 shapes in f32 within their float64 bounds, K4's at bf16 widths "
          f"{[tuple(r['shape'][1:]) for r in k4_rows[len(K4_SHAPES):]]}; the f32 LM's first step "
          f"within {lm['first_step_loss_rel']:.1e} (loss) and {lm['first_update_rel']:.1e} "
          f"(update) of dense attention, K2 {lm['k2_forward']} + {lm['k2_backward']} 3xTF32 in "
          f"{lm['steps']} steps; the f32 ResNet-50's within {resnet50['first_step_loss_rel']:.1e} "
          f"and {resnet50['first_update_rel']:.1e} of the default path, K4 {resnet50['k4']} TF32 "
          f"in {resnet50['steps']} steps; {result['phase_seconds']:.1f} s; on {card}", flush=True)
    return result


def _print_k2(rows: list, card: str) -> None:
    for row in rows:
        for part, r in (("forward", row["forward"]), ("backward", row["backward"]),
                        ("forward+backward", row["backward"]["forward_and_backward"])):
            err = f", max |err| {r['max_abs_err']:.2e}" if "max_abs_err" in r else ""
            ratio = _ratio_text(r, "SDPA") if part != "forward+backward" else ""
            print(f"K2 {part} {row['shape']} {row['layout']} {row['dtype']} "
                  f"causal={row['causal']}: {_times_text(r, 'SDPA')}{ratio}, bound "
                  f"{r['bound_ms']:.4f} ms{err} on {card}", flush=True)


def _print_k3(rows: list, card: str, floor_row: dict | None = None,
              floor_ms: float | None = None) -> None:
    for row in rows:
        device = {k: "not measured" if row[k] is None else f"{row[k]:.4f}"
                  for k in ("device_ms", "plain_device_ms")}
        floor = (f", one launch's floor {floor_ms:.4f} ms" if row is floor_row
                 and floor_ms is not None else "")
        print(f"K3 {row['label']} {row['shape']} {row['layout']} {row['dtype']}: kernel "
              f"{row['ms']:.4f} ms (device {device['device_ms']}), plain {row['plain_ms']:.4f} "
              f"ms (device {device['plain_device_ms']}), no library call, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}){floor}, max |err| "
              f"{row['max_abs_err']:.2e} (f32 q {row['max_abs_err_f32_q']:.2e}) on {card}",
              flush=True)


def _print_k4(rows: list, card: str) -> None:
    for row in rows:
        f64 = row.get("f64_over_bound")
        print(f"K4 {row['dtype']} ({row['instance']}) (M, C, N) {tuple(row['shape'])} "
              f"x{row['calls_per_step']}: {_times_text(row, 'cuDNN')}{_ratio_text(row, 'cuDNN')}, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), max |err| dX "
              f"{row['max_abs_err']:.2e} dW {row['max_abs_err_dw']:.2e}"
              + ("" if f64 is None else ", against f64 over the bound " + ", ".join(
                  f"{part} {who} {v:.3f}" for part, e in f64.items() for who, v in e.items()))
              + (", device ms by kernel " + (", ".join(
                  f"{k} {v:.4f}" for k, v in row["device_ms_by_kernel"].items())
                  or "not measured (the profiler recorded no kernels)")
                 if row["calls_per_step"] and f64 is None else "")
              + f" on {card}", flush=True)


def _k4_step(rows: list) -> dict:
    """A ResNet-50 step's K4 time: the sum over its shapes of calls x
    device ms, for the kernel, the plain version and cuDNN."""
    step = {
        prefix + "device_ms": sum(r["calls_per_step"] * r[prefix + "device_ms"] for r in rows)
        if all(r[prefix + "device_ms"] is not None for r in rows) else None
        for prefix in ("", "plain_", "library_")
    }
    step["bound_ms"] = sum(r["calls_per_step"] * r["bound_ms"] for r in rows)
    step["max_workspace_bytes"] = max(r["workspace_bytes"] for r in rows)
    step["library_ratio"] = (None if None in (step["device_ms"], step["library_device_ms"])
                             else step["device_ms"] / step["library_device_ms"])
    return step


def _times_text(r: dict, library: str) -> str:
    def device(ms):
        return "not measured" if ms is None else f"{ms:.4f}"

    return ", ".join(
        f"{name} {r[prefix + 'ms']:.4f} ms (device {device(r[prefix + 'device_ms'])})"
        for name, prefix in (("kernel", ""), ("plain", "plain_"), (library, "library_"))
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test needs the card", file=sys.stderr)
        return 2
    started = time.monotonic()

    # f32 convolutions and matrix products (the classifier) in full f32,
    # not TF32, on the card as on the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = _card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    builds = {source: _build_in_background(source)
              for source in (K1_SOURCE, K2_SOURCE, K4_SOURCE, K3_SOURCE, K2_TF32_SOURCE,
                             K4_TF32_SOURCE)}

    _join_build(K1_SOURCE, builds[K1_SOURCE], started)
    k1_main = check_k1(256, 1000, seed=0)
    k1_other = [check_k1(4096, 32000, seed=1),
                check_k1(8192, 32768, seed=2, dtype=torch.bfloat16)]
    for row in (k1_main, *k1_other):
        print(_k1_text(row, card), flush=True)

    check_parity()

    _join_build(K2_SOURCE, builds[K2_SOURCE], started)
    k2_rows = [
        check_k2(8, 1024, 12, 64, causal=True, layout="bshd"),
        check_k2(8, 1024, 12, 64, causal=True, layout="bhsd", seed=1),
        check_k2(2, 1000, 4, 64, causal=True, layout="bshd", seed=2),
        check_k2(2, 512, 4, 128, causal=False, layout="bshd", seed=3),
        # ViT-S/16's attention: non-causal, 197 tokens, 256 x 6 heads of 64
        check_k2(256, 197, 6, 64, causal=False, layout="bshd", seed=4),
        # the pipelined LM's microbatch (phase 24: 8 rows in 4 microbatches)
        check_k2(2, 1024, 12, 64, causal=True, layout="bshd", seed=5),
        worked_example_k2_row(),  # phase 34
    ]
    k2_vit = k2_rows[4]
    _print_k2(k2_rows, card)

    check_lm_parity()
    check_moe_lm_parity()
    check_vit_parity()
    resnet = run_resnet50(card)
    lm_launches = run_lm(card)
    vit = run_vit(card)
    moe_lm = run_moe_lm(card)
    ckpt = check_checkpoint_resume(card)
    _join_build(K4_SOURCE, builds[K4_SOURCE], started)
    mesh_one = run_mesh_one_rank(card, lm_launches["step_ms"])
    two_ranks = run_two_ranks(card)
    for row in k2_rows:
        by_kernel = row["backward"]["device_ms_by_kernel"] = k2_backward_by_kernel(row)
        print(f"K2 backward {row['shape']} {row['layout']} causal={row['causal']}: device ms "
              "by kernel " + (", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items())
                              or "not measured (the profiler recorded no kernels)")
              + f" on {card}", flush=True)

    k4_rows = [check_k4(size, c, n, calls, seed)
               for seed, (size, c, n, calls) in enumerate(K4_SHAPES)]
    _print_k4(k4_rows, card)
    k4_step = _k4_step(k4_rows)
    print("K4 per ResNet-50 step (sum of calls x device time): " + ", ".join(
        f"{k} {'not measured' if v is None else f'{v:.4f}'}" for k, v in k4_step.items())
        + f" (library_ratio: kernel / cuDNN) on {card}", flush=True)

    check_fused_parity()
    fused = run_resnet50(card, fused_1x1_bwd=True)
    if not math.isclose(fused["flops_per_step"], resnet["flops_per_step"], rel_tol=FLOPS_RTOL):
        raise AssertionError(f"fused path counts {fused['flops_per_step']} FLOP/step, the "
                             f"default path {resnet['flops_per_step']}")
    print(f"ResNet-50 step: fused {fused['step_ms']:.2f} ms against default "
          f"{resnet['step_ms']:.2f} ms ({fused['step_ms'] / resnet['step_ms'] - 1:+.1%}), "
          f"on {card}", flush=True)
    print(f"ResNet-50 fused_1x1_bwd step: on the mesh (one rank over NCCL, the gradient "
          f"all_reduce made) {mesh_one['resnet50_fused_1x1_bwd_path']['step_ms']:.2f} ms "
          f"against the single-device path's {fused['step_ms']:.2f} ms, on {card}", flush=True)

    _join_build(K3_SOURCE, builds[K3_SOURCE], started)
    floor_ms = launch_floor_ms()
    engine_pos = [300, 511, 17, -1]  # an inactive slot reads all L through trash pages
    verify_pos = [[p + i for i in range(5)] for p in (300, 507, 17, 0)]
    k3_rows = [
        check_k3("generate, pos 639", 8, 1, 12, 640, 64, 639),
        check_k3("generate, pos 127", 8, 1, 12, 640, 64, 127, seed=1),
        check_k3("generate, pos 0", 8, 1, 12, 640, 64, 0, seed=2),
        check_k3("engine decode, per-slot pos", 4, 1, 12, 512, 64, engine_pos, seed=3),
        check_k3("engine verify, 5-query window", 4, 5, 12, 512, 64, verify_pos, seed=4),
        check_k3("drafter, head_dim 16", 4, 1, 2, 512, 16, [300, 511, 17, 200], seed=5),
        check_k3("head_dim 128", 8, 1, 8, 640, 128, 639, seed=6),
        check_k3("head-major bhld", 8, 1, 12, 640, 64, 639, layout="bhld", seed=7),
        check_k3("f32 q", 8, 1, 12, 640, 64, 639, dtype=torch.float32, seed=8),
        # the engine's own calls: its pool read through the page tables
        check_k3("paged engine decode, per-slot pos", 4, 1, 12, 512, 64, engine_pos,
                 layout="paged", seed=9),
        check_k3("paged engine verify, 5-query window", 4, 5, 12, 512, 64, verify_pos,
                 layout="paged", seed=10),
        check_k3("paged drafter, head_dim 16", 4, 1, 2, 512, 16, [300, 511, 17, 200],
                 layout="paged", seed=11),
        # past the first design's 227 KB of scores in shared memory
        check_k3("one query over 65,536 positions", 1, 1, 12, 65536, 64, 65535, seed=12),
        # a rank's half of the batch in the two-process decode of phase 26
        check_k3("two-process decode rank, pos 191", 4, 1, 12, 192, 64, 191, seed=13),
        *worked_example_k3_rows(),  # phase 34
    ]
    _print_k3(k3_rows, card, floor_row=k3_rows[2], floor_ms=floor_ms)
    print(f"one launch's floor (a one-element fill, device time): "
          f"{'not measured' if floor_ms is None else f'{floor_ms:.4f} ms'}, beside K1 "
          f"(256, 1000) f32 {k1_main['device_ms']} and K3 at pos 0 {k3_rows[2]['device_ms']} "
          f"device ms on {card}", flush=True)

    check_decode_parity()
    check_engine_parity()
    k3_step = profile_decode(card)
    decode_launches, decode_single = run_decode(card, k3_step)
    engine_launches = run_engine(card)
    engine_step = profile_engine_step(card)
    breakdowns = profile_breakdowns(card)
    lm_profile = profile_lm_step(card)
    slice10 = run_slice10(card, decode_single)
    slice11 = run_slice11(card)
    serving_plane = run_serving_plane(card)
    gateway_fleet = run_gateway_fleet(card)
    drain = run_maintenance_drain(card)
    shipped = run_shipped_workload(card)
    supervised = run_supervised_elastic(card)
    worked = run_worked_example(card)
    provisioned = run_provision_roofline(card)
    gpu_plane = run_gpu_plane(card)
    head_dims = run_head_dims(card)
    _join_build(K2_TF32_SOURCE, builds[K2_TF32_SOURCE], started)
    _join_build(K4_TF32_SOURCE, builds[K4_TF32_SOURCE], started)
    f32 = run_f32(card)

    k2_lm = k2_rows[0]
    k4_main = max(k4_rows, key=lambda r: r["calls_per_step"] * (r["device_ms"] or r["ms"]))
    kernels = [
        {
            "name": "cross_entropy_fwd (K1)",
            "route": "cuda",
            "source": "tritonk8ssupervisor_tpu_torch/csrc/cross_entropy.cu",
            "replaces": "tritonk8ssupervisor_tpu/ops/cross_entropy.py:56",
            "launches": lm_launches["k1"],
            "launches_by_path": {"resnet50": resnet["k1"], "lm": lm_launches["k1"],
                                 "resnet50_fused_1x1_bwd": fused["k1"], "vit": vit["k1"],
                                 "vit_flash_attention": vit["flash_k1"],
                                 "moe_lm": moe_lm["k1"],
                                 "mesh_lm": mesh_one["lm_path"]["k1"],
                                 "pp_lm_first_step": slice10["pipeline"]["k1"],
                                 "moe_lm_seq_axis_first_step": slice10["moe_seq_axis"]["k1"],
                                 "mesh_resnet50_fused_1x1_bwd":
                                     mesh_one["resnet50_fused_1x1_bwd_path"]["k1"],
                                 "elastic_lm": slice11["elastic_one_rank"]["launches"]["k1"],
                                 "maintenance_drain_lm": drain["launches"]["k1"],
                                 "shipped_lm_job": shipped["lm"]["launches"]["k1"],
                                 "shipped_resnet50_job": shipped["resnet50"]["launches"]["k1"],
                                 "supervised_elastic_lm": supervised["launches"]["k1"],
                                 "worked_example_lm": worked["launches"]["k1"],
                                 "provisioned_lm_job": provisioned["launches"]["k1"],
                                 "gpu_plane_lm_job": gpu_plane["launches"]["k1"],
                                 **{f"lm_num_heads_{n}": r["k1"]
                                    for n, r in head_dims["lm"].items()}},
            "design": "16-byte loads (one element a load where rows are not 16-byte aligned); "
                      "rows of at most 16 loads a lane: one warp a row, 4 rows a CTA, the row in "
                      "registers, max and sum by warp shuffles, the label's logit picked from "
                      "its lane's registers, no shared memory or barrier; wider rows: one CTA "
                      "of 256 threads a row, a per-thread online (max, sum) over 4 loads in "
                      "flight, one block reduction at the end; writes loss, correct and the "
                      "row's logsumexp",
            "first_design": "Triton, one program per row, online logsumexp over column tiles "
                            "with two block reductions a tile, the label's logit picked in its "
                            "tile",
            "launch_floor_ms": floor_ms,
            **_k1_part(k1_other[1], "forward"),
            "other_shapes": [_k1_part(k1_main, "forward"), _k1_part(k1_other[0], "forward"),
                             {**_k1_part(worked["k1"], "forward"),
                              "path": "worked example (phase 34)"}],
        },
        {
            "name": "cross_entropy_bwd (K1)",
            "route": "cuda",
            "source": "tritonk8ssupervisor_tpu_torch/csrc/cross_entropy.cu",
            "replaces": "tritonk8ssupervisor_tpu/ops/cross_entropy.py:237",
            "replaces_note": "the reference's `_dlogits`, which the TPU leaves to XLA's fusion; "
                             "the port's plain backward before this kernel took ~7 launches",
            "launches": lm_launches["k1_backward"],
            "launches_by_path": {
                "resnet50": resnet["k1_backward"], "lm": lm_launches["k1_backward"],
                "resnet50_fused_1x1_bwd": fused["k1_backward"], "vit": vit["k1_backward"],
                "vit_flash_attention": vit["flash_k1_backward"],
                "moe_lm": moe_lm["k1_backward"],
                "mesh_lm": mesh_one["lm_path"]["k1_backward"],
                "pp_lm_first_step": slice10["pipeline"]["k1_backward"],
                "moe_lm_seq_axis_first_step": slice10["moe_seq_axis"]["k1_backward"],
                "mesh_resnet50_fused_1x1_bwd":
                    mesh_one["resnet50_fused_1x1_bwd_path"]["k1_backward"],
                "elastic_lm": slice11["elastic_one_rank"]["launches"]["k1_backward"],
                "maintenance_drain_lm": drain["launches"]["k1_backward"],
                "shipped_lm_job": shipped["lm"]["launches"]["k1_backward"],
                "shipped_resnet50_job": shipped["resnet50"]["launches"]["k1_backward"],
                "supervised_elastic_lm": supervised["launches"]["k1_backward"],
                "worked_example_lm": worked["launches"]["k1_backward"],
                "provisioned_lm_job": provisioned["launches"]["k1_backward"],
                "gpu_plane_lm_job": gpu_plane["launches"]["k1_backward"],
                **{f"lm_num_heads_{n}": r["k1_backward"] for n, r in head_dims["lm"].items()}},
            "design": "one pass (exp(x - lse) - onehot) * g over the logits, read once and "
                      "written once in their dtype with 16-byte loads and stores, over a grid "
                      "of row groups x column chunks of up to 1024 loads (256 threads x 4 in "
                      "flight); g read by its stride (0 from a mean)",
            **_k1_part(k1_other[1], "backward"),
            "other_shapes": [_k1_part(k1_main, "backward"), _k1_part(k1_other[0], "backward"),
                             {**_k1_part(worked["k1"], "backward"),
                              "path": "worked example (phase 34)"}],
        },
        {
            "name": "flash_attn_fwd (K2)",
            "route": "cuda",
            "source": "tritonk8ssupervisor_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tritonk8ssupervisor_tpu/ops/flash_attention.py:128",
            "also_replaces": "tritonk8ssupervisor_tpu/ops/flash_attention.py:163",
            "launches": lm_launches["k2_forward"],
            "input_copies": lm_launches["k2_copies"],
            "design": "TMA-fed wgmma: work items of 128 q rows walked by one persistent CTA "
                      "per SM; q by TMA (two buffers), k/v through a 4-stage TMA ring over 4-d "
                      "tensor maps, one producer thread, two consumer warpgroups of 64 rows; "
                      "S = QK^T wgmma SS, online softmax in f32 registers, O += PV wgmma RS with "
                      "V read MN-major; O stored by TMA",
            "shape": k2_lm["shape"], "layout": k2_lm["layout"],
            **k2_lm["forward"],
            "library_ratio": _library_ratio(k2_lm["forward"]),
            "launches_by_path": {"lm": lm_launches["k2_forward"],
                                 "moe_lm": moe_lm["k2_forward"],
                                 "vit_flash_attention": vit["flash_k2_forward"], "vit": 0,
                                 "mesh_lm": mesh_one["lm_path"]["k2_forward"],
                                 "pp_lm_first_step": slice10["pipeline"]["k2_forward"],
                                 "moe_lm_seq_axis_first_step":
                                     slice10["moe_seq_axis"]["k2_forward"],
                                 "elastic_lm":
                                     slice11["elastic_one_rank"]["launches"]["k2_forward"],
                                 "maintenance_drain_lm": drain["launches"]["k2_forward"],
                                 "shipped_lm_job": shipped["lm"]["launches"]["k2_forward"],
                                 "supervised_elastic_lm": supervised["launches"]["k2_forward"],
                                 "worked_example_lm": worked["launches"]["k2_forward"],
                                 "provisioned_lm_job": provisioned["launches"]["k2_forward"],
                                 "gpu_plane_lm_job": gpu_plane["launches"]["k2_forward"],
                                 **{f"lm_num_heads_{n}": r["k2_forward"]
                                    for n, r in head_dims["lm"].items()}},
            "other_shapes": [{**{k: r[k] for k in ("shape", "layout", "causal", "dtype")},
                              **r["forward"]}
                             for r in (*k2_rows[1:4], *k2_rows[5:7], *head_dims["k2"])],
        },
        {
            "name": "flash_attn_bwd (K2)",
            "route": "cuda",
            "source": "tritonk8ssupervisor_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tritonk8ssupervisor_tpu/ops/flash_attention.py:128",
            "also_replaces": "tritonk8ssupervisor_tpu/ops/flash_attention.py:163",
            "launches": lm_launches["k2_backward"],
            "design": "TMA-fed wgmma: a pre-pass writes each q row's lse*log2e and "
                      "rowsum(dO*O) (padded rows +inf and 0); then a dK/dV kernel over 128-key "
                      "items and a dQ kernel over 128-row q items, each with one persistent CTA "
                      "per SM, one producer thread, two consumer warpgroups of 64 rows (setmaxnreg "
                      "40/232), the item's own tiles loaded once by TMA (two buffers) and 64-row "
                      "tiles of the other side through a TMA ring over 4-d tensor maps; S and dP "
                      "wgmma SS, P and dS in f32 registers, dV, dK and dQ wgmma RS with Q, dO and "
                      "K read MN-major; outputs staged in the item's input tiles and stored by "
                      "TMA; no atomics, bit-equal calls",
            "shape": k2_lm["shape"], "layout": k2_lm["layout"],
            **k2_lm["backward"],
            "library_ratio": _library_ratio(k2_lm["backward"]),
            "launches_by_path": {"lm": lm_launches["k2_backward"],
                                 "moe_lm": moe_lm["k2_backward"],
                                 "vit_flash_attention": vit["flash_k2_backward"], "vit": 0,
                                 "mesh_lm": mesh_one["lm_path"]["k2_backward"],
                                 "pp_lm_first_step": slice10["pipeline"]["k2_backward"],
                                 "moe_lm_seq_axis_first_step":
                                     slice10["moe_seq_axis"]["k2_backward"],
                                 "elastic_lm":
                                     slice11["elastic_one_rank"]["launches"]["k2_backward"],
                                 "maintenance_drain_lm": drain["launches"]["k2_backward"],
                                 "shipped_lm_job": shipped["lm"]["launches"]["k2_backward"],
                                 "supervised_elastic_lm": supervised["launches"]["k2_backward"],
                                 "worked_example_lm": worked["launches"]["k2_backward"],
                                 "provisioned_lm_job": provisioned["launches"]["k2_backward"],
                                 "gpu_plane_lm_job": gpu_plane["launches"]["k2_backward"],
                                 **{f"lm_num_heads_{n}": r["k2_backward"]
                                    for n, r in head_dims["lm"].items()}},
            "other_shapes": [{**{k: r[k] for k in ("shape", "layout", "causal", "dtype")},
                              **r["backward"]}
                             for r in (*k2_rows[1:4], *k2_rows[5:7], *head_dims["k2"])],
        },
        *({
            "name": f"flash_attn_{part[0]}w{part[-1]} (K2), ViT-S/16 shape",  # fwd, bwd
            "route": "cuda",
            "source": "tritonk8ssupervisor_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tritonk8ssupervisor_tpu/ops/flash_attention.py:128",
            "launches": vit[f"flash_k2_{part}"],
            "input_copies": vit["flash_k2_copies"],
            "path": "ViT-S/16 step with attention_fn=flash_attention (the benchmark's ViT "
                    "runs dense attention, as the reference's)",
            "shape": k2_vit["shape"], "layout": k2_vit["layout"], "causal": False,
            **k2_vit[part],
            "library_ratio": _library_ratio(k2_vit[part]),
        } for part in ("forward", "backward")),
        {
            "name": "conv1x1_bwd (K4)",
            "route": "cuda",
            "source": "tritonk8ssupervisor_tpu_torch/csrc/conv_backward.cu",
            "replaces": "tritonk8ssupervisor_tpu/ops/conv_backward.py:83",
            "launches": fused["k4"],
            "launches_by_path": {"resnet50": resnet["k4"], "resnet50_fused_1x1_bwd": fused["k4"],
                                 "mesh_resnet50_fused_1x1_bwd":
                                     mesh_one["resnet50_fused_1x1_bwd_path"]["k4"],
                                 "shipped_resnet50_job": shipped["resnet50"]["launches"]["k4"]},
            "design": "TMA-fed wgmma: persistent dgrad over 128 x {64, 128, 256} tiles (all of "
                      "C up to 256) and wgrad over 128 x 128 tiles and one wave of M splits, each "
                      "a TMA ring with one producer thread and two consumer warpgroups; W, dY^T "
                      "and X read MN-major by the descriptor; dX stored by TMA; dW partials "
                      "summed in split order",
            # the shape with the largest share of a step's K4 time
            **k4_main,
            "library_ratio": _library_ratio(k4_main),
            "per_step": k4_step,
            "other_shapes": [r for r in k4_rows if r is not k4_main],
        },
        *({
            "name": f"flash_attn_{part[0]}w{part[-1]} (K2, 3xTF32 instance)",  # fwd, bwd
            "route": "cuda",
            "source": "tritonk8ssupervisor_tpu_torch/csrc/flash_attention_tf32.cu",
            "replaces": "tritonk8ssupervisor_tpu/ops/flash_attention.py:128",
            "also_replaces": "tritonk8ssupervisor_tpu/ops/flash_attention.py:163",
            "launches": f32["lm"][f"k2_{part}"],
            "path": "the f32 LM (dtype = logits_dtype = float32) with flash_attention",
            "design": ("3xTF32 wgmma (lo*hi + hi*lo + hi*hi into f32): a producer warpgroup "
                       "reads K and V with plain loads (any strides), splits them and writes hi "
                       "and lo K-major (V transposed, keys permuted to P's fragment order) into an "
                       "mbarrier ring of 64-column chunks; two consumer warpgroups of 64 q rows "
                       "split q's A fragments from a raw tile, S = QK^T, online softmax in f32 "
                       "registers, O += PV with P split in registers; persistent CTAs, longest "
                       "causal items first")
            if part == "forward" else
            ("3xTF32 wgmma: a rows pre-pass (rowsum(dO*O), a warp a row), a dK/dV kernel "
             "(K, V raw; Q and dO split as rows and transposed in 32-row steps) and a dQ kernel "
             "(Q, dO raw; K and V split as rows, K transposed), each recomputing S and dP; dS "
             "of a single-key row set to its exact 0; no atomics, bit-equal calls"),
            "first_design": "f32 FMAs on the CUDA cores: CTAs of 16 x 16 threads with register "
                            "tiles of scores over tiles transposed in shared memory",
            "shape": f32["k2"][0]["shape"], "layout": f32["k2"][0]["layout"], "dtype": "float32",
            **f32["k2"][0][part],
            "library_ratio": _library_ratio(f32["k2"][0][part]),
            "other_shapes": [{**{k: r[k] for k in ("shape", "layout", "causal", "dtype")},
                              **r[part]} for r in f32["k2"][1:]],
        } for part in ("forward", "backward")),
        {
            "name": "conv1x1_bwd (K4, 3xTF32 instance)",
            "route": "cuda",
            "source": "tritonk8ssupervisor_tpu_torch/csrc/conv_backward_tf32.cu",
            "replaces": "tritonk8ssupervisor_tpu/ops/conv_backward.py:83",
            "launches": f32["resnet50"]["k4"],
            "path": "ResNet-50 in f32 with fused_1x1_bwd (route tf32x3); bf16 and fp16 at "
                    "widths that are not multiples of 8 (route tf32x1)",
            "design": "TF32 wgmma, every f32 product lo*hi + hi*lo + hi*hi (one exact product "
                      "for bf16 and fp16): a producer warpgroup loads rows with plain loads (any "
                      "width and start), splits them and writes hi and lo K-major (dY as rows, "
                      "W, dY and X transposed) into an mbarrier ring; two consumer warpgroups "
                      "of 64 rows run m64n{64,128,256}k8 from shared memory; persistent CTAs over "
                      "128 x {64, 128, 256} tiles, wgrad over one wave of M splits summed in "
                      "order; contractions shorter than 16 as exact f32 FMAs",
            "first_design": "f32 FMAs on the CUDA cores (csrc/conv_backward_fma.cu, removed): "
                            "SIMT GEMMs of 128 x 128 tiles, 8 x 8 a thread from k-major shared "
                            "tiles of depth 8; its times stand in PERF.md section 6",
            **f32["k4"][0],
            "library_ratio": _library_ratio(f32["k4"][0]),
            "per_step": f32["k4_per_step"],
            "other_shapes": f32["k4"][1:],
        },
        {
            "name": "decode_attn_int8 (K3)",
            "route": "cuda",
            "source": "tritonk8ssupervisor_tpu_torch/csrc/decode_attention.cu",
            "replaces": "tritonk8ssupervisor_tpu/ops/decode_attention.py:58",
            "launches": decode_launches["decode_cache_int8"],
            "launches_by_path": {**decode_launches, "engine_cache_int8": engine_launches,
                                 "mesh_decode_cache_int8": slice10["decode_mesh"]["k3"],
                                 "two_process_decode_cache_int8_per_rank":
                                     slice10["decode_two_ranks"]["k3"],
                                 "serving_plane_drill": serving_plane["k3_launches"],
                                 "gateway_fleet_drive": gateway_fleet["k3_launches"],
                                 "worked_example_generate_cache_int8":
                                     worked["decode"]["cache_int8"]["k3"],
                                 "generate_head_dim_40_cache_int8": head_dims["generate_k3"]},
            "library_none_reason": "no PyTorch call computes attention over an int8 cache "
                                   "with per-token scales",
            "library_ratio": None,
            "design": "split-K over fixed 64-position chunks (flash-decoding): one CTA of "
                      "128 threads per (b, h, chunk), chunks past the row's last position exit; "
                      "all of a chunk's K/V rows and scales in flight at once (16- and 4-byte "
                      "cp.async, the paged layout through the page table, one copy a row); "
                      "scores, chunk softmax and values from shared memory in f32, int8 to f32 "
                      "by byte permute; per-chunk (m, l, o) partials, combined in chunk order "
                      "by the row's last CTA (an acquire-release counter), or written directly "
                      "when the row has one chunk; a query's bits depend only on its own pos",
            "first_design": "one CTA of 256 threads per (b, h) holding the window's queries; "
                            "scores, f32 softmax and values over 16-byte int8 rows, reads stop "
                            "at pos + 1; fixed-order reductions",
            "launch_floor_ms": floor_ms,
            # the last position of the dense decode benchmark
            **k3_rows[0],
            # K3's profiled device time in one dense decode step at pos 383
            "decode_step": k3_step,
            # K3 and the page gathers in one engine decode step (torch.profiler)
            "engine_step": engine_step,
            "other_shapes": [*k3_rows[1:], *head_dims["k3"]],
        },
    ]
    print("slice 8: " + json.dumps({"vit": vit, "moe_lm": moe_lm, "checkpoint": ckpt,
                                    "profiles": breakdowns}, sort_keys=True), flush=True)
    print("slice 9: " + json.dumps({"mesh_one_rank": mesh_one, "two_ranks": two_ranks},
                                   sort_keys=True, default=str), flush=True)
    print("slice 10: " + json.dumps(slice10, sort_keys=True, default=str), flush=True)
    print("slice 11: " + json.dumps(slice11, sort_keys=True, default=str), flush=True)
    print("slice 12: " + json.dumps(serving_plane, sort_keys=True, default=str), flush=True)
    print("slice 13: " + json.dumps(gateway_fleet, sort_keys=True, default=str), flush=True)
    print("slice 14: " + json.dumps({"analyzers": serving_plane["analyzers"],
                                     "maintenance_drain": drain}, sort_keys=True), flush=True)
    print("slice 15: " + json.dumps({"shipped_workload": shipped,
                                     "fleet_demand": gateway_fleet["fleet_demand"]},
                                    sort_keys=True, default=str), flush=True)
    print("slice 16: " + json.dumps({"supervised_elastic": supervised}, sort_keys=True,
                                    default=str), flush=True)
    print("slice 17: " + json.dumps({"worked_example": worked}, sort_keys=True, default=str),
          flush=True)
    print("slice 18: " + json.dumps({"k1": [k1_main, *k1_other, worked["k1"]],
                                     "lm_step_profile": lm_profile}, sort_keys=True), flush=True)
    print("slice 19: " + json.dumps({"provision_roofline": provisioned}, sort_keys=True,
                                    default=str), flush=True)
    print("slice 20: " + json.dumps({"gpu_plane": gpu_plane}, sort_keys=True, default=str),
          flush=True)
    print("every dtype and width: " + json.dumps({"f32": f32}, sort_keys=True, default=str),
          flush=True)
    print(f"chip_smoke: all phases passed in {time.monotonic() - started:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--lm-step-profile"]:  # that profile alone, on the package beside it
        if not torch.cuda.is_available():
            sys.exit(2)
        torch.backends.cudnn.allow_tf32 = False  # as main() runs it
        torch.backends.cuda.matmul.allow_tf32 = False
        profile_lm_step(_card_line())
        sys.exit(0)
    if sys.argv[1:] == ["--engine-step"]:  # that phase alone, e.g. on another tree's package
        if not torch.cuda.is_available():
            sys.exit(2)
        profile_engine_step(_card_line())
        sys.exit(0)
    if sys.argv[1:] == ["--serving-plane"]:  # phase 29 alone, K3 built first
        if not torch.cuda.is_available():
            sys.exit(2)
        torch.backends.cudnn.allow_tf32 = False  # as main() runs it
        torch.backends.cuda.matmul.allow_tf32 = False
        cuda_build.load(K3_SOURCE)
        run_serving_plane(_card_line())
        sys.exit(0)
    if sys.argv[1:] == ["--gateway-fleet"]:  # phase 30 alone, K3 built first
        if not torch.cuda.is_available():
            sys.exit(2)
        torch.backends.cudnn.allow_tf32 = False  # as main() runs it
        torch.backends.cuda.matmul.allow_tf32 = False
        cuda_build.load(K3_SOURCE)
        run_gateway_fleet(_card_line())
        sys.exit(0)
    if sys.argv[1:] == ["--maintenance-drain"]:  # phase 31 alone, K1 and K2 built first
        if not torch.cuda.is_available():
            sys.exit(2)
        check_k1(8192, 32768, seed=2, dtype=torch.bfloat16)
        cuda_build.load(K2_SOURCE)
        run_maintenance_drain(_card_line())
        sys.exit(0)
    if sys.argv[1:] == ["--shipped-workload"]:  # phase 32 alone, built from the install
        if not torch.cuda.is_available():
            sys.exit(2)
        run_shipped_workload(_card_line())
        sys.exit(0)
    if sys.argv[1:] == ["--supervised-elastic"]:  # phase 33 alone, K1 and K2 built first
        if not torch.cuda.is_available():
            sys.exit(2)
        check_k1(8192, 32768, seed=2, dtype=torch.bfloat16)
        cuda_build.load(K2_SOURCE)
        run_supervised_elastic(_card_line())
        sys.exit(0)
    if sys.argv[1:] == ["--worked-example"]:  # phase 34 alone, K1, K2 and K3 built first
        if not torch.cuda.is_available():
            sys.exit(2)
        torch.backends.cudnn.allow_tf32 = False  # as main() runs it
        torch.backends.cuda.matmul.allow_tf32 = False
        cuda_build.load(K2_SOURCE)
        cuda_build.load(K3_SOURCE)
        rows = [worked_example_k2_row(), *worked_example_k3_rows()]
        print("worked example kernels: " + json.dumps(rows, sort_keys=True), flush=True)
        run_worked_example(_card_line())
        sys.exit(0)
    if sys.argv[1:] == ["--gpu-plane"]:  # phase 36 alone, K1 and K2 built first
        if not torch.cuda.is_available():
            sys.exit(2)
        cuda_build.load(K1_SOURCE)
        cuda_build.load(K2_SOURCE)
        run_gpu_plane(_card_line())
        sys.exit(0)
    if sys.argv[1:] == ["--head-dims"]:  # phase 37 alone, K1, K2 and K3 built first
        if not torch.cuda.is_available():
            sys.exit(2)
        torch.backends.cudnn.allow_tf32 = False  # as main() runs it
        torch.backends.cuda.matmul.allow_tf32 = False
        for source in (K1_SOURCE, K2_SOURCE, K3_SOURCE):
            cuda_build.load(source)
        run_head_dims(_card_line())
        sys.exit(0)
    if sys.argv[1:] == ["--f32"]:  # phase 38 alone, K1 and the f32 instances built first
        if not torch.cuda.is_available():
            sys.exit(2)
        torch.backends.cudnn.allow_tf32 = False  # as main() runs it
        torch.backends.cuda.matmul.allow_tf32 = False
        for source in (K1_SOURCE, K2_TF32_SOURCE, K4_TF32_SOURCE):
            cuda_build.load(source)
        run_f32(_card_line())
        sys.exit(0)
    if sys.argv[1:] == ["--provision-roofline"]:  # phase 35 alone, K1 and K2 built first
        if not torch.cuda.is_available():
            sys.exit(2)
        cuda_build.load(K1_SOURCE)
        cuda_build.load(K2_SOURCE)
        run_provision_roofline(_card_line())
        sys.exit(0)
    sys.exit(main())
