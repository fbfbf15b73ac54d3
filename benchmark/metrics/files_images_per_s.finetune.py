"""``files_images_per_s.finetune``: Images/s of the files-fed finetune over its traced window (its runs spread too widely to bound end to end)."""

from bmk.readers import images_per_s as read  # noqa: F401
