"""demo2program_tpu — a neural program synthesis framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
shaohua0116/demo2program ("Neural Program Synthesis from Diverse Demonstration
Videos", ICML 2018): given k demonstration videos of an agent executing an
unknown program, synthesize the program in a DSL and score it by token match,
canonical-program match, and execution accuracy.

Layer map (bottom → top), mirroring SURVEY.md §1 but re-architected for
batched accelerator execution:

  envs/      host-side environment simulators (Karel numpy oracle, ViZDoom
             wrapper) used for dataset generation and as the ground-truth
             semantics reference.
  dsl/       per-domain DSL: vocab, recursive-descent parser → AST, exact
             reference-semantics interpreter, canonicalizer, CFG sampler,
             prefix-syntax oracle, and a bytecode compiler feeding the
             on-device VM.
  ops/       JAX compute: the vectorized Karel VM (batched on-device
             program execution for execution-accuracy scoring), grid codecs,
             compact-batch reconstruction.
  data/      dataset generation into `.npz` stores (the reference's
             data.hdf5 schema; reference .hdf5 files still load), host
             loader, prefetching device pipeline.
  models/    explicit-parameter JAX model families: synthesis baseline,
             summarizer, full (multi-task), induction baseline.
  parallel/  mesh construction + sharding rules (data parallelism).
  train/     jitted train step, checkpointing, metric reporting.
  eval/      greedy decode + syntax/canonical/execution scoring + report files.
  cli/       trainer/evaler/generator entry points with reference flag parity.
"""

__version__ = "0.1.0"
