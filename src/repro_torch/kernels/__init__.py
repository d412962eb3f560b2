"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

  fused_logpdf/  fused elementwise log-density + row reduction for the
                 flat-buffer log-joint (``site_block_sum``): the
                 std_normal, bernoulli_logits, categorical_logits and
                 gamma families.
  fused_leapfrog/ the whole n-step leapfrog for a separable potential
                 (an opcode table) in one launch for all chains, and the
                 one-shot potential value plus gradient.

The kernels are built with ``nvcc`` at first use (``_build.py``); on a
CPU tensor every wrapper runs the plain version instead.
"""
