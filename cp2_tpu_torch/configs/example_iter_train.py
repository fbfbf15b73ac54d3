# Example config for the port's iteration CLI (cp2_tpu_torch/train/iter_train.py),
# a copy of cp2_tpu/configs/example_iter_train.py (mmseg-style iter-based
# training).  Set the img/ann dirs via environment or edit in place.
import os

norm_cfg = dict(type="SyncBN", requires_grad=True)

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
        style="pytorch",
        contract_dilation=True,
    ),
    decode_head=dict(
        type="ASPPHead",
        in_channels=2048,
        in_index=3,
        channels=512,
        dilations=(1, 6, 12, 18),
        dropout_ratio=0.1,
        num_classes=2,
        norm_cfg=norm_cfg,
        align_corners=False,
    ),
    auxiliary_head=None,
    train_cfg=dict(),
    test_cfg=dict(mode="whole"),
)

data = dict(
    train=dict(
        img_dir=os.environ.get("TRAIN_IMG_DIR", "/data/images"),
        ann_dir=os.environ.get("TRAIN_ANN_DIR", "/data/masks"),
        img_size=int(os.environ.get("IMG_SIZE", "512")),
        batch_size=int(os.environ.get("BATCH", "8")),
    ),
    val=dict(
        img_dir=os.environ.get("VAL_IMG_DIR", "/data/images"),
        ann_dir=os.environ.get("VAL_ANN_DIR", "/data/masks"),
    ),
)

optimizer = dict(type="SGD", lr=0.003, momentum=0.9, weight_decay=0.0)
lr_config = dict(policy="poly", power=0.9, min_lr=1e-4)
runner = dict(type="IterBasedRunner", max_iters=40000)
checkpoint_config = dict(by_epoch=False, interval=4000)
evaluation = dict(interval=4000, metric="mIoU")
