"""``rn50.conv_ms``: device milliseconds a step in the kernels that
``aten::convolution`` and ``aten::convolution_backward`` launched (cuDNN),
over the steps traced with the host's calls (which attribute each kernel
to the call that launched it)."""


def read(run):
    t = run.call_summary
    if (run.kind != "train" or not t
            or run.ref_cfg["MODEL"]["VISUAL_MODEL"] != "m_resnet50"):
        return None
    return t["by_family_ms"].get("convolutions", 0.0) or None
