"""paddle_tpu_torch.analysis — static and on-card analysis of the port.

The port's counterpart of ``paddle_tpu/analysis``. It holds the kernel
analysis tier (:mod:`.kernels`, rules CK200-CK209) and the shared pieces
that tier needs: findings and severities (:mod:`.diagnostics`), the file
walk (:mod:`.engine`) and the command-line contract (:mod:`.cli`).
"""
