"""The analysis suite: VA scoring of saved images, low-level metrics, the
significance tests, FID/KID/ISC and result processing. Port of
``rgie_tpu/analysis``; nothing here needs pandas or matplotlib unless a
function that makes a frame or a figure is called."""
