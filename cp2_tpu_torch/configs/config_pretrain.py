# CP2 pretrain model: dilated ResNet-50 (output-stride 16) + ASPP head with
# the 128-d dense contrast projector.  Mirrors the knobs of the reference
# configs/config_pretrain.py:1-35.  Kept as a copy of the JAX package's file
# so that the port imports nothing of it; on one card "SyncBN" and "BN" are
# the same BatchNorm over the whole batch.
norm_cfg = dict(type="SyncBN", requires_grad=True)
pretrain_path = "torchvision://resnet50"  # resolved by checkpoint.convert if present

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
        contrast=True,
        dilations=(1, 6, 12, 18),
        dropout_ratio=0.1,
        num_classes=2,
        norm_cfg=norm_cfg,
        align_corners=False,
        loss_decode=dict(type="CrossEntropyLoss", use_sigmoid=False, loss_weight=1.0),
    ),
    auxiliary_head=None,
    train_cfg=dict(),
    test_cfg=dict(mode="whole"),
)
