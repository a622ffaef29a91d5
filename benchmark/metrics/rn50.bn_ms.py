"""``rn50.bn_ms``: device milliseconds a step in BatchNorm kernels (the
yardstick's family table, by kernel name), over the traced steps."""


def read(run):
    t = run.trace_summary
    if (run.kind != "train" or not t
            or run.ref_cfg["MODEL"]["VISUAL_MODEL"] != "m_resnet50"):
        return None
    return t["by_family_ms"].get("BN", 0.0) or None
