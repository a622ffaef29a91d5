"""``attention_roofline``: the roofline bounds of the ViT tower's K5
(forward) and K6 (backward) launches over their device time, in the
traced steps, each launch bounded at the tower's shape by the
yardstick's frozen work counts."""

from benchmark.harness.yardstick import attention_work, bound_ms, device_peaks


def read(run):
    t = run.trace_summary
    peaks = device_peaks(run.device_name) if run.on_card else None
    if (run.kind != "train" or not t or not peaks
            or run.ref_cfg["MODEL"]["VISUAL_MODEL"] == "m_resnet50"):
        return None
    ms = t["by_family_ms"].get("K5", 0.0) + t["by_family_ms"].get("K6", 0.0)
    if ms <= 0.0:
        return None
    vit = run.ref_cfg["MODEL"]["VIT"]
    seq = ((run.ref_cfg["INPUT"]["HEIGHT"] // vit["PATCH_SIZE"])
           * (run.ref_cfg["INPUT"]["WIDTH"] // vit["PATCH_SIZE"]) + 1)
    b = run.ref_cfg["SOLVER"]["IMS_PER_BATCH"]
    bound = sum(
        t["launches"].get(name, 0.0) * bound_ms(
            *attention_work(b, seq, vit["WIDTH"], vit["HEADS"], backward),
            peaks, "bfloat16")[0]
        for name, backward in (("K5", False), ("K6", True)))
    return 100.0 * bound / ms
