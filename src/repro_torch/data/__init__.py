from repro_torch.data.synthetic import (ShapeDtype,  # noqa: F401
                                        SyntheticTokens, host_shard)
