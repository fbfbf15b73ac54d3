# MoCo/BYOL pretrain model: standard-stride ResNet-50 (OS=32) with a
# passthrough FCN head (num_convs=0) — the image-level baselines use raw
# stage-4 features.  Mirrors reference configs/config_moco.py:1-33.  Kept as
# a copy of the JAX package's file so that the port imports nothing of it;
# ``init_cfg`` is left out (checkpoints load through the bridge, nothing is
# downloaded).
norm_cfg = dict(type="BN", requires_grad=True)

model = dict(
    type="EncoderDecoder",
    backbone=dict(
        type="ResNet",
        depth=50,
        num_stages=4,
        out_indices=(0, 1, 2, 3),
        dilations=(1, 1, 1, 1),
        strides=(1, 2, 2, 2),
        norm_cfg=norm_cfg,
        norm_eval=False,
        style="pytorch",
        contract_dilation=False,
    ),
    decode_head=dict(
        type="FCNHead",
        num_convs=0,
        concat_input=False,
        in_channels=2048,
        in_index=3,
        channels=2048,
        num_classes=2,
        norm_cfg=norm_cfg,
    ),
    auxiliary_head=None,
    train_cfg=dict(),
    test_cfg=dict(mode="whole"),
)
