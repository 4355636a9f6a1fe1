from repro_torch.kernels.mlstm_scan.ops import mlstm_scan, mlstm_scan_plain
