from nsparse_tpu_torch.formats.csr import CSR

__all__ = ["CSR"]
