# Supervised finetune model: same dilated ResNet-50 (OS=16) with the ASPP
# classifier head (no contrast branch).  Mirrors reference
# configs/config_finetune.py:1-35; num_classes is set by the finetune entry.
# Kept as a copy of the JAX package's file so that the port imports nothing
# of it; ``init_cfg`` is dropped by the segmentor (checkpoints load through
# ``checkpoint/convert.py``).
norm_cfg = dict(type="SyncBN", requires_grad=True)
pretrain_path = "torchvision://resnet50"

model = dict(
    type="EncoderDecoder",
    backbone=dict(
        type="ResNet",
        depth=50,
        num_stages=4,
        out_indices=(0, 1, 2, 3),
        dilations=(1, 1, 1, 2),
        strides=(1, 2, 2, 1),
        norm_cfg=norm_cfg,
        norm_eval=False,
        style="pytorch",
        init_cfg=dict(type="Pretrained", checkpoint=pretrain_path),
        contract_dilation=True,
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
        loss_decode=dict(type="CrossEntropyLoss", use_sigmoid=False, loss_weight=1.0),
    ),
    auxiliary_head=None,
    train_cfg=dict(),
    test_cfg=dict(mode="whole"),
)
