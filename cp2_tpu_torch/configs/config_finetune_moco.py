# Finetune-from-MoCo model: standard-stride ResNet-50 (OS=32) with the ASPP
# classifier head.  Mirrors reference configs/config_finetune_moco.py:1-35.
# Kept as a copy of the JAX package's file so that the port imports nothing
# of it.
norm_cfg = dict(type="SyncBN", requires_grad=True)
pretrain_path = "torchvision://resnet50"

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
        init_cfg=dict(type="Pretrained", checkpoint=pretrain_path),
        contract_dilation=False,
    ),
    decode_head=dict(
        type="ASPPHead",
        in_channels=2048,
        in_index=3,
        channels=512,
        dilations=(1, 6, 12, 18),
        dropout_ratio=0.1,
        num_classes=None,
        norm_cfg=norm_cfg,
        align_corners=False,
    ),
    auxiliary_head=None,
    train_cfg=dict(),
    test_cfg=dict(mode="whole"),
)
