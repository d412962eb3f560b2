"""repro_torch.nn — the LM substrate (dict-of-tensors parameters):
attention (dense or the flash kernel), the Mamba-2 SSD mixer (plain scan
or the ssd_scan kernel) and the LM assembly."""
