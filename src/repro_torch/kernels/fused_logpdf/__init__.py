from repro_torch.kernels.fused_logpdf.ops import (  # noqa: F401
    LAUNCHES, SITE_BLOCK_FAMILIES,
    bernoulli_logit_sum_rows, bernoulli_logits_logpmf_sum,
    categorical_logits_logpmf_sum, categorical_logits_sum_rows,
    gamma_unnorm_logpdf_sum, gamma_unnorm_sum_rows,
    reset_launch_counts, site_block_sum, std_normal_logpdf_sum,
    std_normal_sum_rows)
