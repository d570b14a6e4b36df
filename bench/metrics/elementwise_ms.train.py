"""Device milliseconds a traced step spends outside matrix products, the
two hand-written model kernels and NCCL: the models' elementwise work and
the optimizer's, by kernel name."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr.get("steps"):
        return None
    g = tr["by_group"]
    rest = sum(v for k, v in g.items()
               if k not in ("matmul", "flash_attention", "ssd_intra_chunk",
                            "nccl"))
    return 1e3 * rest / tr["steps"]
