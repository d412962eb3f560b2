from repro_torch.kernels.fused_logpdf.ops import (  # noqa: F401
    LAUNCHES, SITE_BLOCK_FAMILIES, all_reduce_block_sum,
    bernoulli_logit_sum_rows, bernoulli_logits_logpmf_sum,
    beta_unnorm_logpdf_sum, beta_unnorm_sum_rows,
    categorical_logits_logpmf_sum, categorical_logits_sum_rows,
    gamma_unnorm_logpdf_sum, gamma_unnorm_sum_rows,
    mvn_quadform_sum_rows, mvnormal_prec_quadform_sum, normal_logpdf_sum,
    normal_sum_rows, reset_launch_counts, site_block_sum,
    std_normal_logpdf_sum, std_normal_sum_rows, student_t_unnorm_logpdf_sum,
    student_t_unnorm_sum_rows)
