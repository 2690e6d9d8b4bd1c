"""Training driver.

Parity target: the reference `trainer.py` — model registry, Adam + clip 20,
optional exponential LR decay, periodic test inference / summary / checkpoint
cadence, train-dir naming with the hyperparameter string, warm-start from a
pretrained checkpoint, and the `sec/batch, instances/sec` log line
(`trainer.py:227-240`).

Differences: batches go host->device once (sharded over the data mesh
axis); the train step is one jitted SPMD program; checkpoints are `.npz`
pytrees (train/checkpoint.py); metrics stream to stdout + metrics.jsonl
instead of TensorBoard events.
"""

import json
import os
import time

import jax
import numpy as np

from demo2program_tpu.data import BatchPipeline
from demo2program_tpu.dsl.karel_vocab import KarelVocab
from demo2program_tpu.models import get_model_class
from demo2program_tpu.models.common import ModelConfig
from demo2program_tpu.parallel import make_mesh, batch_sharding
from demo2program_tpu.train import checkpoint
from demo2program_tpu.train.step import (
    create_train_state, make_eval_step, make_optimizer, make_train_step)
from demo2program_tpu.utils import log


def config_from_dataset(args, dataset):
    """Infer data dims from the first datum, mirroring
    `trainer.py:304-335`."""
    item = dataset.get_data(dataset.ids[0])
    if args.dataset_type == "vizdoom":
        from demo2program_tpu.dsl.vizdoom_vocab import VizDoomDSLVocab
        vocab = VizDoomDSLVocab(perception_type=dataset.perception_type,
                                level=dataset.level)
        return ModelConfig(
            model=args.model,
            dataset_type="vizdoom",
            batch_size=args.batch_size,
            num_lstm_cell_units=args.num_lstm_cell_units,
            encoder_rnn_type=getattr(args, "encoder_rnn_type", "lstm"),
            demo_aggregation=args.demo_aggregation,
            scheduled_sampling=args.scheduled_sampling,
            scheduled_sampling_decay_steps=(
                args.scheduled_sampling_decay_steps),
            compute_dtype=getattr(args, "compute_dtype", "float32"),
            beam_width=getattr(args, "beam_width", 5),
            dim_program_token=item["program"].shape[0],
            max_program_len=item["program"].shape[1],
            k=item["s_h"].shape[0],
            test_k=item["test_s_h"].shape[0],
            max_demo_len=item["s_h"].shape[1],
            h=item["s_h"].shape[2],
            w=item["s_h"].shape[3],
            depth=item["s_h"].shape[4],
            action_space=item["a_h"].shape[2],
            per_dim=item["per"].shape[2],
            dsl_type="vizdoom_default",
            env_type="vizdoom_default",
            vizdoom_pos_keys=tuple(dataset.vizdoom_pos_keys),
            vizdoom_max_init_pos_len=dataset.vizdoom_max_init_pos_len,
            perception_type=dataset.perception_type,
            level=dataset.level,
            sprite_style=getattr(dataset, "sprite_style", "v2"),
            program_end_token=vocab.end_token,
        )
    vocab = KarelVocab()
    return ModelConfig(
        model=args.model,
        dataset_type=args.dataset_type,
        batch_size=args.batch_size,
        num_lstm_cell_units=args.num_lstm_cell_units,
        encoder_rnn_type=getattr(args, "encoder_rnn_type", "lstm"),
        demo_aggregation=args.demo_aggregation,
        scheduled_sampling=args.scheduled_sampling,
        scheduled_sampling_decay_steps=args.scheduled_sampling_decay_steps,
        compute_dtype=getattr(args, "compute_dtype", "float32"),
        beam_width=getattr(args, "beam_width", 5),
        dim_program_token=item["program"].shape[0],
        max_program_len=item["program"].shape[1],
        k=item["s_h"].shape[0],
        test_k=item["test_s_h"].shape[0],
        max_demo_len=item["s_h"].shape[1],
        h=item["s_h"].shape[2],
        w=item["s_h"].shape[3],
        depth=item["s_h"].shape[4],
        action_space=item["a_h"].shape[2],
        per_dim=item["per"].shape[2],
        dsl_type=dataset.dsl_type,
        env_type=dataset.env_type,
        program_end_token=vocab.end_token,
    )


class Trainer:
    def __init__(self, args, dataset_train, dataset_test, cfg=None,
                 pipe_train=None, num_devices=None, cache_budget_bytes=None):
        self.args = args
        self.cfg = cfg or config_from_dataset(args, dataset_train)
        cfg = self.cfg

        hp = "bs_{}_lr_{}_{}_cell_{}".format(
            args.batch_size, args.learning_rate, args.encoder_rnn_type,
            args.num_lstm_cell_units)
        if args.scheduled_sampling:
            hp += "_sd_{}".format(args.scheduled_sampling_decay_steps)
        hp += "_k_{}".format(args.num_k)
        self.train_dir = args.train_dir or "./train_dir/{}-{}-{}-{}-{}".format(
            args.dataset_type, args.model, args.prefix, hp,
            time.strftime("%Y%m%d-%H%M%S"))
        os.makedirs(self.train_dir, exist_ok=True)
        log.infov("Train Dir: %s", self.train_dir)

        # data-parallel mesh over the largest device count (of
        # `num_devices`, default all) that divides the batch
        n_avail = num_devices or jax.device_count()
        n_dev = n_avail
        while args.batch_size % n_dev != 0:
            n_dev -= 1
        if n_dev != n_avail:
            log.warn("batch_size %d not divisible by %d devices; using a "
                     "%d-device mesh", args.batch_size, n_avail, n_dev)
        self.mesh = make_mesh(num_devices=n_dev)
        sharding = batch_sharding(self.mesh)
        # Karel streams use the compact wire format (token ids + initial
        # states; ops/reconstruct.py rebuilds full tensors inside the jitted
        # step) — ~90x fewer host->device bytes per item. ViZDoom frames are
        # engine video and not reconstructible, so they ship whole.
        compact = args.dataset_type == "karel"
        # the train step never reads the unseen-test tensors; dropping them
        # from the train stream saves host->device traffic
        if compact:
            train_drop = ("test_c_wall", "test_c_marker", "test_c_agent",
                          "test_c_a_raw", "test_c_a_row_len",
                          "test_demo_len")
        else:
            train_drop = ("test_s_h", "test_a_h", "test_a_h_tokens",
                          "test_per", "test_demo_len", "test_init_pos",
                          "test_init_pos_len")
        if args.model == "induction_baseline":
            train_drop = ()  # induction trains ON the test-demo actions
        # A caller may hand in a ready train pipe (scripts/doom_stage_runner
        # reuses one device-resident DoomDeviceCache across several training
        # stages, so the split is read and pushed once per dataset instead
        # of once per stage).
        self.pipe_train = pipe_train
        self.karel_cache = None
        if self.pipe_train is None and compact and os.environ.get(
                "D2P_KAREL_DEVICE_CACHE", "1") != "0":
            # Karel compact split is tens of MB — cache it on device,
            # replicated, and run the CHUNKED train loop (many steps per
            # dispatch, batch sampling on device; train/step.py
            # make_chunked_train_step). No per-step host->device traffic.
            from demo2program_tpu.train.device_cache import KarelDeviceCache
            self.karel_cache = KarelDeviceCache(
                dataset_train, mesh=self.mesh,
                include_test=(args.model == "induction_baseline"))
        if self.pipe_train is None \
                and args.dataset_type == "vizdoom" and os.environ.get(
                "D2P_DOOM_DEVICE_CACHE", "1") != "0":
            from demo2program_tpu.train.device_cache import (
                DoomDeviceCache, device_budget_bytes, estimate_cache_bytes)
            est = estimate_cache_bytes(dataset_train)
            # a caller's budget replaces the one sized from the device
            budget = (cache_budget_bytes if cache_budget_bytes is not None
                      else device_budget_bytes(jax.devices()[0]))
            if budget is None:
                log.info("%s backend has no device memory limit; streaming "
                         "the doom train split", jax.default_backend())
            elif est / n_dev <= budget:
                # doom frames are engine video: cache the whole train split
                # in device memory once (sharded over the mesh's devices),
                # gather batches on device by indices — per-step wire
                # traffic becomes a (bs,) index vector
                self.pipe_train = DoomDeviceCache(
                    dataset_train, args.batch_size, seed=args.seed,
                    mesh=self.mesh,
                    include_test_actions=(
                        args.model == "induction_baseline"))
            else:
                log.warn("doom train split ~%.1f GB/device exceeds the "
                         "device cache budget (%.1f GB); falling back to "
                         "streaming", est / n_dev / 1e9, budget / 1e9)
        if self.pipe_train is None and self.karel_cache is None:
            self.pipe_train = BatchPipeline(
                dataset_train, args.batch_size, shuffle=True,
                seed=args.seed, sharding=sharding, drop_keys=train_drop,
                compact=compact)
        # test stream shuffles like the reference's shuffle_batch test queue
        self.pipe_test = _InfiniteEval(dataset_test, args.batch_size,
                                       args.seed, sharding, compact=compact)

        model_cls = get_model_class(args.model)
        self.model = model_cls(cfg, train=True)
        self.eval_model = model_cls(cfg, train=False)
        self.tx = make_optimizer(cfg, args.learning_rate,
                                 args.lr_weight_decay)
        rng = jax.random.key(args.seed)
        # device-resident training data for the CHUNKED loop (many steps
        # per dispatch, on-device batch sampling): the Karel compact cache,
        # or a single-shard doom device cache (the sharded multi-device
        # doom cache keeps per-shard host cursors and streams instead)
        self._chunk_data = None
        if self.karel_cache is not None:
            example = self.karel_cache.example_batch(args.batch_size)
            self._chunk_data = (self.karel_cache.data, self.karel_cache.n)
            self._chunk_fns = {}  # chunk length -> jitted scan-of-steps
            self._batch_sharding = sharding
        else:
            example = next(self.pipe_train)
            from demo2program_tpu.train.device_cache import DoomDeviceCache
            if (isinstance(self.pipe_train, DoomDeviceCache)
                    and self.pipe_train.n_shards == 1):
                self._chunk_data = (self.pipe_train._data,
                                    len(self.pipe_train._ids))
                self._chunk_fns = {}
                self._batch_sharding = sharding
        self.state = create_train_state(self.model, cfg, self.tx, rng,
                                        example)
        self._first_batch = example
        self.train_step = make_train_step(self.model, cfg, self.tx,
                                          args.model)
        self.eval_step = make_eval_step(self.eval_model, cfg, args.model)
        # per-step model rng is fold_in(base, step) — a pure function of the
        # step index, so a killed-and-resumed run sees the identical rng
        # stream (exact resume; split-chains would restart from the seed)
        self.rng = rng

        self.ckpt_dir = os.path.join(os.path.abspath(self.train_dir), "ckpt")
        # Crash auto-resume (reference Supervisor semantics,
        # `trainer.py:123-140`): relaunching the same command into an
        # existing train_dir restores the latest checkpoint — full state
        # incl. opt_state and step — and continues the loop from there.
        # Takes precedence over --checkpoint (which is a stage-warm-start,
        # not a resume).
        self._auto_resumed = False
        latest = checkpoint.latest_step(self.ckpt_dir)
        if latest is not None:
            if args.checkpoint:
                log.warn("train_dir has checkpoints (latest step %d); "
                         "auto-resuming from them and IGNORING "
                         "--checkpoint %s", latest, args.checkpoint)
            restored = checkpoint.restore(
                checkpoint.path_of(self.ckpt_dir, latest), self.state)
            # replicate the host arrays over the mesh so the jitted step
            # sees consistent placements
            from demo2program_tpu.parallel import replicated_sharding
            self.state = jax.device_put(restored,
                                        replicated_sharding(self.mesh))
            self._auto_resumed = True
            # EXACT resume: replay the data stream to where the dead run
            # was. The chunked Karel path needs nothing (batch indices are a
            # pure function of (seed, step)); streaming pipes fast-forward
            # their index draws by `latest` batches.
            if self._chunk_data is None \
                    and hasattr(self.pipe_train, "fast_forward"):
                self.pipe_train.fast_forward(latest)
            log.infov("Auto-resumed from %s step %d (exact: batch sequence "
                      "and per-step rng replay deterministically)",
                      self.ckpt_dir, latest)
        elif args.checkpoint:
            self.restore(args.checkpoint)

        n_params = sum(x.size for x in jax.tree_util.tree_leaves(
            self.state.params))
        log.warn("total trainable parameters: %.2fM", n_params / 1e6)
        self.metrics_file = open(
            os.path.join(self.train_dir, "metrics.jsonl"), "a")
        # decoded-program observability (reference text summaries,
        # `model_full.py:1188-1221`)
        if args.dataset_type == "vizdoom":
            from demo2program_tpu.dsl.vizdoom_vocab import VizDoomDSLVocab
            self.vocab = VizDoomDSLVocab(
                perception_type=dataset_train.perception_type,
                level=dataset_train.level)
        else:
            self.vocab = KarelVocab()
        self.samples_file = open(
            os.path.join(self.train_dir, "samples.txt"), "a")

    # -- checkpointing --------------------------------------------------------
    def save(self):
        step = int(self.state.step)
        if step in checkpoint.all_steps(self.ckpt_dir):
            return  # already on disk (resume relaunch after a final save)
        checkpoint.save(self.ckpt_dir, step, self.state)
        log.infov("Saved checkpoint at %d", step)

    def restore(self, path):
        """Warm-start parameters (and batch stats) from a checkpoint dir
        (mirrors the reference pretrain_saver, `trainer.py:142-147`)."""
        restored = checkpoint.restore(os.path.abspath(path), self.state)
        from demo2program_tpu.parallel import replicated_sharding
        self.state = jax.device_put(restored,
                                    replicated_sharding(self.mesh))
        log.info("Restored checkpoint from %s (step %d)", path,
                 int(self.state.step))

    # -- loop ------------------------------------------------------------------
    def _log_line(self, split, step, report, step_time):
        step_time = max(step_time, 1e-3)
        log.info(
            " [%5s step %6d] Loss: %.5f (%.3f sec/batch, "
            "%.3f instances/sec)", split, step,
            float(report["loss"]), step_time,
            self.args.batch_size / step_time)

    def _write_metrics(self, split, step, report):
        rec = {"split": split, "step": int(step), "time": time.time()}
        for k, v in report.items():
            v = np.asarray(v)
            if v.ndim == 0:
                rec[k] = float(v)
        self.metrics_file.write(json.dumps(rec) + "\n")
        self.metrics_file.flush()

    def _write_samples(self, step, batch, evals, n=3):
        """Decoded (gt, pred, greedy) program triplets per test-sample step —
        the text-summary half of the reference's mid-training observability
        (`model_full.py:1188-1221`); appended to <train_dir>/samples.txt and
        one triplet echoed to the console. No-op for the induction baseline
        (dummy program fetches, `model_induction.py:866-875`)."""
        if not evals or "pred_tokens" not in evals:
            return
        gt_tokens = np.asarray(batch["program_tokens"])
        gt_len = np.asarray(batch["program_len"])[:, 0].astype(int)
        lines = [f"# step {step}"]
        for i in range(min(n, gt_tokens.shape[0])):
            gt = self.vocab.intseq2str(gt_tokens[i, :gt_len[i]])
            pred = self.vocab.intseq2str(
                np.asarray(evals["pred_tokens"])[i,
                                                 :int(evals["pred_len"][i])])
            lines.append(f"gt    : {gt}")
            lines.append(f"pred  : {pred}")
            if "greedy_tokens" in evals:
                greedy = self.vocab.intseq2str(
                    np.asarray(evals["greedy_tokens"])[
                        i, :int(evals["greedy_len"][i])])
                lines.append(f"greedy: {greedy}")
        self.samples_file.write("\n".join(lines) + "\n")
        self.samples_file.flush()
        log.info("sample @%d | gt: %s | greedy: %s", step,
                 lines[1][8:], lines[3][8:] if len(lines) > 3 else "-")
        if getattr(self.args, "sample_images", False):
            self._write_sample_images(step, batch, evals)

    def _write_sample_images(self, step, batch, evals):
        """PNG observability artifacts (reference image summaries,
        `model_full.py:1223-1297`): a gt / pred / greedy program one-hot
        heatmap strip, and the first demo rendered as a tile strip
        (Karel only)."""
        import cv2

        out_dir = os.path.join(self.train_dir, "samples")
        os.makedirs(out_dir, exist_ok=True)
        V = self.cfg.dim_program_token
        gt = np.asarray(batch["program_tokens"])[0]
        rows = [np.eye(V, dtype=np.uint8)[gt].T * 255]
        for key in ("pred_tokens", "greedy_tokens"):
            if key in evals:
                rows.append(np.eye(V, dtype=np.uint8)[
                    np.asarray(evals[key])[0]].T * 255)
        sep = np.full((2, rows[0].shape[1]), 128, np.uint8)
        heat = np.concatenate(
            sum(([r, sep] for r in rows), [])[:-1], axis=0)
        cv2.imwrite(os.path.join(out_dir, f"step_{step}_program.png"),
                    np.kron(heat, np.ones((3, 3), np.uint8)))

        if self.args.dataset_type != "karel" or "c_wall" not in batch:
            return
        from demo2program_tpu.envs.karel import KarelWorld, batch_to_states
        from demo2program_tpu.tools.karel_render import state2image
        wall = np.asarray(batch["c_wall"])[0, :1]
        marker = np.asarray(batch["c_marker"])[0, :1]
        agent = np.asarray(batch["c_agent"])[0, :1]
        actions = np.asarray(batch["c_a_raw"])[0, 0]
        dlen = int(np.asarray(batch["demo_len"])[0, 0])
        world = KarelWorld(batch_to_states(wall, marker, agent)[0],
                           make_error=False)
        for a in actions[:dlen - 1]:
            world.state_transition(int(a))
        strip = np.concatenate([state2image(s) for s in world.s_h], axis=1)
        cv2.imwrite(os.path.join(out_dir, f"step_{step}_demo.png"),
                    strip[:, :, ::-1].astype(np.uint8))  # RGB->BGR for cv2

        # action-decoder map (reference visualized_action,
        # `model_full.py:1266-1275`): first demo's per-step action
        # probabilities (R) against the recorded gt actions (G)
        if "pred_action_probs" in evals:
            probs = np.asarray(evals["pred_action_probs"])[0]  # (T, A)
            T_, A_ = probs.shape
            gt_oh = np.zeros((T_, A_), np.float32)
            ids = np.asarray(batch["c_a_raw"])[0, 0]
            n_act = min(dlen - 1, T_)
            gt_oh[np.arange(n_act), ids[:n_act]] = 1.0
            if n_act < T_:
                gt_oh[n_act, A_ - 1] = 1.0  # <e>
            rgb = np.stack([probs.T, gt_oh.T,
                            np.zeros_like(probs.T)], axis=-1)
            cv2.imwrite(
                os.path.join(out_dir, f"step_{step}_action.png"),
                np.kron((rgb[:, :, ::-1] * 255).astype(np.uint8),
                        np.ones((8, 8, 1), np.uint8)))

        # perception-map summary (reference `model_full.py:1223-1297`):
        # gt per-step perception vectors (replayed) above the perception
        # head's sigmoid probabilities, per primitive x timestep
        if "pred_per" in evals:
            gt_per = np.asarray(world.p_v_h, np.float32).T  # (P, T')
            pred = np.asarray(evals["pred_per"])[0, 0].T    # (P, T)
            Tn = gt_per.shape[1]
            sep = np.full((1, Tn), 0.5, np.float32)
            per_map = np.concatenate([gt_per, sep, pred[:, :Tn]], axis=0)
            cv2.imwrite(
                os.path.join(out_dir, f"step_{step}_per.png"),
                np.kron((per_map * 255).astype(np.uint8),
                        np.ones((8, 8), np.uint8)))

    def train(self, max_steps=1_000_000):
        args = self.args
        # `max_steps` counts steps for THIS stage: a fresh (or warm-started)
        # run targets state.step + max_steps and records that target in
        # resume.json; an auto-resumed relaunch reads the target back so it
        # finishes the original stage instead of appending max_steps more.
        start = int(self.state.step)
        resume_path = os.path.join(self.train_dir, "resume.json")
        target = start + max_steps
        if self._auto_resumed and os.path.exists(resume_path):
            with open(resume_path) as f:
                target = int(json.load(f)["target_step"])
        else:
            with open(resume_path, "w") as f:
                json.dump({"target_step": target}, f)
        if start >= target:
            log.infov("Nothing to do: step %d >= target %d", start, target)
            return
        log.infov("Training Starts! (step %d -> %d)", start, target)
        if self._chunk_data is not None:
            self._train_chunked(start, target)
            return
        profile_steps = getattr(args, "profile_steps", 0)
        profile_start = start + getattr(args, "profile_start", 10)
        # jitted steps dispatch asynchronously: per-iteration wall time is
        # near zero except at log steps, where device_get drains the whole
        # window's device backlog — so sec/batch is computed over the window
        # (steps since the previous log sync), not the last iteration
        win_t, win_s = time.time(), start - 1
        for s in range(start, target):
            if profile_steps and s == profile_start:
                # SURVEY.md §5: the reference has no tracing at all; capture
                # a jax.profiler trace over a window of steps
                jax.profiler.start_trace(
                    os.path.join(self.train_dir, "profile"))
                log.infov("profiler trace started at step %d", s)
            t0 = time.time()
            batch = next(self.pipe_train)
            t_data = time.time() - t0
            step_rng = jax.random.fold_in(self.rng, s)
            self.state, report = self.train_step(self.state, batch, step_rng)
            if profile_steps and s == profile_start + profile_steps - 1:
                jax.block_until_ready(report["loss"])
                jax.profiler.stop_trace()
                log.infov("profiler trace written to %s",
                          os.path.join(self.train_dir, "profile"))
            if s % args.log_step == 0:
                report = jax.device_get(report)
                report["sec_data_wait"] = t_data
                now = time.time()
                self._log_line("train", int(self.state.step), report,
                               (now - win_t) / max(s - win_s, 1))
                win_t, win_s = now, s
                self._write_metrics("train", self.state.step, report)
            if s % args.test_sample_step == 0:
                self._test_sample()
                win_t, win_s = time.time(), s  # keep eval out of the window
            # checkpoints land on exact multiples of ckpt_save_step (state
            # .step is s+1 here; keying on s put every mid-run ckpt at step
            # N+1 — ckpt/20000 never existed and downstream per-step evals
            # silently fell back, the root of ADVICE r3 high)
            if (s + 1) % args.ckpt_save_step == 0:
                self.save()
                win_t, win_s = time.time(), s
        self.save()

    def _test_sample(self):
        """One eval-model forward on a test batch + sample/metric logging
        (the reference's every-100-step test run, `trainer.py:169-174`)."""
        t1 = time.time()
        test_batch = next(self.pipe_test)
        test_report, test_evals = self.eval_step(self.state, test_batch)
        test_report = jax.device_get(test_report)
        self._log_line("val", int(self.state.step), test_report,
                       time.time() - t1)
        self._write_metrics("val", self.state.step, test_report)
        self._write_samples(int(self.state.step), test_batch,
                            jax.device_get(test_evals))

    def _train_chunked(self, start, target):
        """Device-cache train loop: many steps per dispatch (lax.scan over
        the jitted step with on-device batch sampling) — no per-step host
        work. Host-side
        events (logging / test-sample / checkpoints) happen at the cadence
        boundaries, which define the chunk lengths; with aligned cadences
        every chunk is log_step long (one compile)."""
        args = self.args
        from demo2program_tpu.train.step import make_chunked_train_step
        data, n_items = self._chunk_data
        cadences = [args.log_step, args.test_sample_step,
                    args.ckpt_save_step]
        # distinct stream from the per-step model rng (fold_in of the same
        # key would collide data and dropout/sampling streams)
        data_key = jax.random.fold_in(self.rng, 0x5eed)
        s = start
        # report fetches run ONE chunk behind the dispatch so the
        # device->host fetch overlaps the next chunk's compute instead of
        # serializing with it (win["pending"] holds the un-fetched
        # (boundary_step, device report) of the previous log boundary)
        win = {"t": time.time(), "s": start}

        def _flush():
            if win.get("pending") is None:
                return
            b, rep_dev = win.pop("pending")
            report = jax.device_get(rep_dev)
            now = time.time()
            self._log_line("train", b, report,
                           (now - win["t"]) / max(b - win["s"], 1))
            win["t"], win["s"] = now, b
            self._write_metrics("train", b, report)

        while s < target:
            if s % args.test_sample_step == 0:
                _flush()
                self._test_sample()
                win["t"], win["s"] = time.time(), s
            nxt = min([((s // c) + 1) * c for c in cadences] + [target])
            chunk = nxt - s
            fn = self._chunk_fns.get(chunk)
            if fn is None:
                if self._chunk_fns:
                    log.warn("new chunk length %d (cadences not aligned); "
                             "compiling another chunked step", chunk)
                fn = make_chunked_train_step(
                    self.model, self.cfg, self.tx, args.model,
                    n_items, args.batch_size, chunk,
                    sharding=self._batch_sharding)
                self._chunk_fns[chunk] = fn
            self.state, reports = fn(self.state, data, data_key,
                                     self.rng)
            s = nxt
            if s % args.log_step == 0 or s == target:
                _flush()
                win["pending"] = (s, jax.tree_util.tree_map(
                    lambda a: a[-1], reports))
            if s % args.ckpt_save_step == 0 and s < target:
                self.save()
                win["t"], win["s"] = time.time(), s
        _flush()
        self.save()


class _InfiniteEval:
    """Endless shuffled eval batches (the reference's test queue also
    shuffles, `input_ops_karel.py` via shuffle_batch)."""

    def __init__(self, dataset, batch_size, seed, sharding, compact=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.sharding = sharding
        self.compact = compact
        self._pipe = None

    def __next__(self):
        if self._pipe is None:
            self._pipe = BatchPipeline(
                self.dataset, self.batch_size, shuffle=True,
                seed=self.seed, sharding=self.sharding, prefetch=1,
                compact=self.compact)
        return next(self._pipe)
