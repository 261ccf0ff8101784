#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``opticalflow_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it builds the CUDA kernels from the
sources there.  Every phase fails loudly (an assertion or exception exits
non-zero, and no result line is printed):

  1. build the four kernels (one ``nvcc`` each, started together) and
     print the build time and the compiler's register/shared-memory report
     (no instantiation may spill);
  2. hold the correlation kernel (K1/K2) against its plain PyTorch version
     on the card: every level of a 448x1024 input at B=1 and B=8, the
     1088x1920 level-2 shape and a ragged shape, float32 and bfloat16; then,
     per level at 448x1024 (B=1, B=8) and at 1088x1920, in float32 and
     bfloat16: two runs bit-equal, the tile, grid and channel split the
     kernel chose, its time on the card alone, by CUDA events back to back
     and the host's time to queue it, beside its bound and the plain
     version;
  3. hold the fused warp+correlation kernel (K3) against its plain version:
     levels 2-5 of 448x1024 at B=1 and B=8, the ragged 9x45x20 and the
     1088x1920 level 2, float32 and bfloat16, both mask thresholds, flows
     of x3 and x20 px; then its probe entry point, which checks it and, per
     level 2-5 at B=1 and B=8 in float32 and bfloat16, prints the plan the
     kernel chose, that two runs gave the same bits, and its time on the
     card alone, by events and on the host beside the composed path's
     (warp, then K1) and the bound, for noise flows of x3 and x20 px and a
     smooth flow;
  4. hold the row gather kernel (K4) against its plain version, exactly and
     NaN rows included; then its probe entry point, beside
     ``torch.index_select``, with the wrapper's host time by piece; and the
     card's time for the smallest launch through the shared launch path
     (one row), the floor under every B=1 time above;
  5. the main path through its entry points: the single-pair CLI on the
     real golden frames with fake reference weights, in pad mode against
     ``tests/goldens/real_pair_pad.flo`` and in its default resize mode
     against ``real_pair.flo``, and ``FlowEngine`` in pad_ref mode against
     ``real_pair_padref.flo``, 5 kernel launches each, OpenCV never
     imported;
  6. full width: ``FlowEngine`` in pad and resize mode at Sintel 436x1024,
     float32, B=1 and B=8 — pairs/s, latency, peak memory, and the host
     resize alone; the forward alone by CUDA events;
  7. hold the correlation backward kernel (B1) against its plain version:
     every level of a 320x896 training crop at B=4 and of a 448x1024 frame
     at B=1, float32 and bfloat16, two runs bit-equal; per level its time
     on the card alone and by events beside its bound and the plain
     version, and its plan (tile, split, blocks an SM, registers);
  8. the training step at full width (``train.trainer``, the multiscale
     loss, AdamW lr 1e-4, wd 1e-4, clip 1.0, a seeded batch of 4 x 320x896):
     in float32 parity mode one step's gradients through K1 and B1 against
     the same step through the plain correlation; then 10 steps in the
     fast mode, which must lower the loss, 5 K1 and 5 B1 launches each —
     ms per step and pairs/s;
  9. evaluation: synthetic KITTI 2015 (375x1242, 16-bit GT written by the
     port from the engine's own flow, ~30% invalid) and Sintel (436x1024,
     ``.flo`` GT) trees through ``cli/infer_kitti`` and ``cli/eval_sintel``
     at batch 2 (the last chunk padded): EPE within the PNG's 1/64 px and
     below 1e-3 — pairs/s;
 10. the training CLI (``cli/train.main`` with the fake weights as
     ``--pretrained``): (a) the multiscale regime at 4x320x896 over 2
     epochs on a synthetic KITTI training tree (16 pairs of 375x1242, a
     smooth known motion, ~30% invalid; --val-frac 0.25): six
     uninterrupted runs, and one preempted by SIGTERM after its first step
     and resumed, which must start from the state the preempted run saved,
     bit for bit (parameters, AdamW's moments and step counts, learning
     rates, step), log steps 1..N once each, see the same batches (CRC-32
     of their images) and end, against each uninterrupted run, within 4x
     the largest pairwise spread of those runs in parameters and per-step
     losses; (b) the epipolar
     regime (--epi-soft-w 0.1, 384x512) on frames of a moving camera:
     finite losses and Sampson term, masks neither empty nor full, 10 K1
     and 5 B1 launches a step; (c) the CLI's samples/s (its own print,
     and its steady rate from the steps' start times in a 4-epoch run
     without validation), the loader alone and the step alone on a batch
     on the card;
 11. streaming video: on the card, K1/K2 against the plain correlation at
     every level the video path gives it (768x1280 and 1088x1920, B=4,
     float32 and bfloat16, phase 2's tolerances), the I420 unpack
     bit-exact to ``io/yuv``, the grid decimation within 1e-4 of the
     host's, and in float32 parity mode the i420 runner against the bgr
     runner fed I420-round-tripped frames (1e-4); then
     ``cli/extract_video`` with the fake weights on a 240-frame 720x1280
     moving clip (.y4m, written by the port) at B=4 in bfloat16, in each
     mode (arrows with both uploads, color, vanish --shrink 0.75, topview;
     40-240 frames each) and in arrows on a 64-frame 1080x1920 clip: each
     output's frame count and size (N-1 frames), 5 K1 launches a window,
     (B+1) frames' bytes uploaded a window (I420: 1.5 bytes a pixel,
     unpadded); each run's fps from its first frame read to its writer's
     release, its fill, and the host's busy ms a frame and share of the
     run by stage and thread (decode, warp, upload, issue, wait, draw,
     encode); the forward alone; the engine's ``resize_fixed`` (engine
     and ``cli/infer_kitti``) against the port on the CPU (1e-4) and
     ``flow_from_batch`` against the pad path;
 12. serving: ``cli/serve`` in a child process at its defaults (bfloat16
     fast, --max-batch 8, --max-delay-ms 5, auto buckets, --warmup
     436x1024) with the fake weights; 16 client threads send 128 raw
     requests of moving 436x1024 pairs, then one client 16 in a row (the
     B=1 bucket), then 4 JSON requests of the same frames as base64 PNGs,
     which must return the raw route's bytes; /healthz and /metrics
     (requests, errors, batches); a burst of 16 drained by SIGTERM (every
     answer 200, exit code 0); K1 5 times a batch and a warm-up forward;
     requests/s, p50/p90/p99 latency of both, mean occupancy, the dispatch
     thread's share of the burst in the engine and in the host resize,
     peak memory; a float32 parity-mode ``FlowServer`` in this process,
     each response within 1e-4 mean EPE of ``flow_from_pair``; the engine
     alone at B=8 and B=1 in the CLI's mode;
 13. export: the float32 parity model exported with the correlation
     operator (``dynamic="all"``), loaded and run at 1x448x1024,
     4x448x1024, 1x64x64 and 2x1088x1920 against the eager model
     (epe_mean < 1e-5, agree@0.25 100%), 5 K1 launches a call; an
     artifact of the plain correlation (static, 1x448x1024) against it;
     ``cli/parity`` at 1x448x1024 (PARITY: PASS, its report PNG); export
     time and each forward by CUDA events beside the eager model's;
 14. data parallelism on the one card (``parallel/``; NCCL refuses two
     ranks on one device, so two ranks share it, over gloo: the backend
     the mesh picks when the launched ranks outnumber the cards, and its
     device the card ``distributed_init`` selected): (a) two ranks
     launched by ``torch.distributed.run``, each on its half of phase 8's
     4x320x896 batch with KITTI-like valid masks that differ between the
     halves, one float32 parity-mode AdamW step against the one-process
     step on the whole batch (loss, grad norm, gradients and the update,
     to 1e-3 of the largest or 4x cuDNN's run-to-run spread), K1 and B1 5
     a step on every rank; then 5 fast-mode steps, ms per step per rank;
     (b) a one-rank NCCL group (``--data-parallel all``): 3 fast-mode
     steps against the mesh-less ones, the NCCL version; (c)
     ``cli/infer_kitti --data-parallel 2`` under ``torch.distributed.run``
     on phase 9's synthetic KITTI tree, within 1e-4 EPE of one process;
     (d) a lockstep float32 ``FlowServer`` on each rank, a 436x1024
     request within 1e-4 mean EPE of ``flow_from_pair``; (e) at
     1x1024x1920 the halo exchange (halo 256, slab 512: the exact case)
     against the monolithic forward, the halo exchange with halo 128
     (slab 512 > 2 x halo: each rank's window a part of the frame)
     against the one-process tiled path with the same windows (tile 512,
     halo 256), and the tiled path (tile 512, halo 64) over 2 ranks
     against one process, to 1e-4, and the tiled seams' deviation; (f)
     ``VideoFlowRunner(mesh=)`` over a 10-frame 436x1024 clip at B=4 (the
     last window partial), rank 0 reading it, on both gloo ranks and on
     the one-rank NCCL group: every rank's triples within 1e-4 mean EPE of
     the one-process runner, their frames equal, K1 5 a window a rank;
     then what gloo's send/recv and an NCCL group of two ranks on one card
     do (recorded);
 15. JPEG on the card machine, which has no PIL, imageio or OpenCV (the
     port's own decoder, ``runtime/jpeg.cpp``, built by g++ at first use):
     (a) every fixture of ``tests/goldens/jpeg/`` decodes to its manifest
     digest through ``load_image`` (PIL's pixels) and ``decode_image``
     (OpenCV's, EXIF orientation applied), none of the three imported;
     (b) ``cli/script_pwc`` on the 436x1024 JPEG pair in resize and pad
     mode, 5 K1 launches each, its ``.flo`` equal bit for bit to
     ``FlowEngine.flow_from_pair`` on the decoded arrays; (c) ``cli/serve``
     at its defaults answers a JSON request of the base64 JPEG pair with
     the raw route's bytes for the same pixels, and requests/s from 16
     clients on each route; (d) ``cli/train --regime pseudo`` for 2 steps
     over a directory of the JPEG frames at 384x512: finite losses, 5 K1
     and 5 B1 launches a step; (e) ``cli/extract_video --mode arrows`` over
     a directory of 1080x1920 JPEG frames (K2's levels); (f) the host ms
     to decode one 436x1024 and one 1080x1920 frame on 1 and 4 threads,
     beside ``decode_png`` of the same pixels;
 16. compare mode (``viz/overlay.opencv_flow``: OpenCV's baselines
     written without it; ``runtime/dis.cpp`` built by g++ first, outside
     the runs): (b) Farneback on the card against the same
     function on the CPU on one 720x1280 pair, both parameter sets, to
     1e-4 mean EPE, and its ms a pair; (a) ``cli/extract_video --mode
     compare`` for each of farneback, dis and lucaskanade_dense over a
     moving 16-frame 720x1280 clip at B=4: 2w-wide output frames, K1 5 a
     window, fps over the whole run, the baseline's ms a pair (Farneback
     on the card, DIS on the host); (c) no cv2, PIL or imageio imported;
 17. MPEG-4 Part 2 video on the card machine, through neither OpenCV nor
     FFmpeg (the port's codec, ``runtime/mpeg4.cpp``, built by g++ in
     phase 1): (a) every MPEG-4 and raw fixture of
     ``tests/goldens/video/`` decodes to its manifest's frame digests and
     cv2's fps, size and count (the Motion JPEG ones are phase 18's), cv2
     and PIL not imported; (b) the port's writer takes a moving
     48-frame clip at 720x1280 and at 1080x1920 into ``.mp4``: every frame
     read back equals the encoder's reconstruction, I-VOPs at 0, 12, 24,
     36; bytes, PSNR against the source, host ms a frame to encode and to
     decode on one thread, and of BGR->I420 in C (the writers') against
     its numpy reference; (c) ``cli/extract_video --mode arrows --batch 4
     --dtype bfloat16`` from the 720p ``.mp4`` to an ``.mp4``, from the
     same frames as ``.y4m`` to ``.y4m``, and 16 frames of the 1080p
     ``.mp4`` (K2's levels): fps over each run, the decode and encode
     threads' busy shares, K1 5 a window; (d) ``cli/capture_frame`` at
     frame 30 (third GOP) equals ``read_frames``' frame 30; (e) ``cli/train
     --regime pseudo`` for 2 steps at 4x384x512 over an ``.mp4`` of the
     clip's first 9 frames: finite losses, K1 and B1 5 a step;
 18. Motion JPEG and image sequences read as ``cv2.VideoCapture`` reads
     them (``runtime/jpeg.cpp``'s FFmpeg flavour and swscale's conversion
     in ``runtime/ffmpeg_dsp.h``): (a) every fixture of
     ``tests/goldens/jpeg/`` decodes to the digest of cv2.VideoCapture's
     frame, every Motion JPEG fixture of ``tests/goldens/video/`` to its
     frame digests and cv2's fps, size and count; (b) a 48-frame 436x1024
     source alternating the committed ``sintel_im1.jpg`` and
     ``sintel_im2.jpg`` bytes, as a ``%06d.jpg`` pattern and as an MJPEG
     AVI (the port's RIFF muxer), and a 16-frame 1080p AVI of
     ``frame_1080p.jpg``; (c) ``cli/extract_video --mode arrows --batch 4
     --dtype bfloat16`` over each, and over a ``.y4m`` of the same
     436x1024 frames: fps over each run, the decode thread's busy ms a
     frame, K1 5 a window; (d) ``cli/capture_frame`` at frame 23 of the
     AVI; (e) ``cli/train --regime pseudo`` for 2 steps at 4x384x512 over
     a 9-frame pattern: K1 and B1 5 a step; (f) host ms to decode the
     436x1024 and the 1080p JPEG on one thread, FFmpeg flavour beside the
     libjpeg one; (g) no cv2, PIL or jax in ``sys.modules``;
 19. VP8 and Matroska/WebM read as ``cv2.VideoCapture`` reads them
     (``runtime/vp8.cpp``, ``io/mkv.py``; ``.y4m`` and odd heights
     converted as swscale converts them): (a) every fixture of
     ``tests/goldens/video/`` added with them (``vp8_*``, ``mkv_*``,
     ``mpeg4_*``) decodes to its manifest's cv2 digests, fps, size and
     count; (b) ``cli/extract_video --mode arrows --batch 4 --dtype
     bfloat16`` over the committed 13-frame 436x1024 VP8 WebM (the Sintel
     JPEG pair alternating), over a ``.y4m`` of its frames, and from the
     WebM to ``.mkv``: fps, the decode thread's ms a frame, K1 15 a run;
     (c) ``cli/capture_frame`` at frame 12 (the second key frame) against
     its digest; (d) ``cli/train --regime pseudo`` for 2 steps at
     4x384x512 over a 9-frame ``.webm`` remuxed from the committed one:
     K1 and B1 5 a step; (e) host ms to decode a 436x1024 frame on one
     thread, VP8 beside MPEG-4 Part 2 of the same frames; (f) no cv2, PIL
     or jax in ``sys.modules``;
 20. VP9 read as ``cv2.VideoCapture`` reads it (``runtime/vp9.cpp``, in
     ``.webm``, ``.mkv``, ``.mp4`` and ``.avi``): (a) every ``vp9_*``
     fixture the port reads (cv2's writer; libvpx's hidden alt-ref frames,
     compound prediction, backward adaptation, segmentation, lossless,
     tiles, error resilience, full range and BT.709; rewritten headers:
     intra-only frames, show_existing_frame, segment features, sharpness,
     delta quantisers, bilinear) and the VP8 clamping_type one decode to
     their manifest's cv2 digests, fps, size and count, and the resize one
     is refused; (b) ``cli/extract_video
     --mode arrows --batch 4 --dtype bfloat16`` over the committed 13-frame
     436x1024 VP9 WebM (4 tile columns), over a ``.y4m`` of its frames,
     and from the WebM to ``.mkv``: K1 15 a run; (c) ``cli/capture_frame``
     at frame 12; (d) ``cli/train --regime pseudo`` for 2 steps over a
     9-frame VP9 ``.webm``: K1 and B1 5 a step; (e) host ms to decode a
     436x1024 frame on one thread, VP9 beside VP8 and MPEG-4 Part 2 of the
     same frames; (f) no cv2, PIL or jax in ``sys.modules``;
 21. MPEG-1 and MPEG-2 read as ``cv2.VideoCapture`` reads them
     (``runtime/mpeg12.cpp`` behind ``io/mpegps`` and the AVI, Matroska and
     MP4 demuxers): (a) every ``mpeg1_*``/``mpeg2_*`` fixture the port
     reads (cv2's writer in four containers, odd-size patches, a still;
     libavcodec's intra VLC, non-linear quantiser, 9-11-bit DC, BT.709,
     closed GOPs and low delay; rewritten headers: alternate scan, custom
     and chroma matrices, broken_link) decodes to its manifest's cv2
     digests, fps, size and count, every seek the manifest records reads
     cv2's frame (quirks included), and the interlaced one is refused; (b)
     ``cli/extract_video --mode arrows --batch 4 --dtype bfloat16`` over
     the committed 13-frame 436x1024 MPEG-2 ``.mpg``, over a ``.y4m`` of
     its frames, and from the ``.mpg`` to ``.mkv``: K1 15 a run; (c)
     ``cli/capture_frame`` at a B-picture (frame 13 of the 176x144
     ``.mpg``); (d) ``cli/train --regime pseudo`` for 2 steps over the
     committed 10-frame ``mpeg2_sintel_head_436x1024.mpg`` (the Sintel
     one's first pictures, a PTS on each): K1 and B1 5 a step;
     (e) host ms to decode a 436x1024 frame on one thread, MPEG-2 beside
     MPEG-4 Part 2, VP8 and VP9 of the same frames; (f) no cv2, PIL or jax
     in ``sys.modules``;
 22. VP9 size changes and H.263 (host C++: ``runtime/vp9.cpp``'s scaled
     prediction, ``runtime/h263.cpp``, swscale's scaler between sizes in
     ``runtime/ffmpeg_dsp.h``): (a) every H.263 fixture (cv2's writer in
     ``.avi``/``.3gp``/``.mov``/``.mkv``; libavcodec's Annex F, 8x8
     vectors, GOB headers with PSUPP, a size change, the 4CIF Sintel clip),
     the MPEG-4 Part 2 ``.3gp`` and every stream that changes size (VP9 in
     WebM and AVI, VP8, MPEG-4 Part 2, MPEG-2) decodes to its manifest's
     cv2 digests, fps, size and count, and every recorded seek reads cv2's
     frame; (b) ``cli/extract_video --mode arrows --batch 4 --dtype
     bfloat16`` over ``h263_sintel_704x576.avi`` and
     ``vp9_resize_sintel_436x1024.webm`` (218x512 from frame 5, scaled
     back): K1 15 a run; (c) ``cli/train --regime pseudo`` for 2 steps over
     the resizing WebM's first 9 frames: K1 and B1 5 a step; (d) host ms to
     decode a frame, H.263 beside MPEG-4 Part 2 and the resizing VP9
     beside the unscaled one, and to convert a scaled picture; (e) no cv2,
     PIL or jax in ``sys.modules``;
 23. transport streams, elementary streams and FFV1 (``io/mpegts``,
     ``io/elementary``, MPEG-4 Part 2 in ``io/mpegps``, host C++
     ``runtime/ffv1.cpp`` behind the Matroska, AVI and MP4 demuxers): (a)
     every such fixture (MPEG-1/2 and MPEG-4 Part 2 in .ts/.m2ts/.mts,
     split PES packets and continuity gaps, .m1v/.m2v/.mpv/.h263/.263,
     MPEG-4 Part 2 in .mpg; FFV1 from cv2's writer in .mkv/.avi/.mp4/.mov
     and libavcodec's versions 0-3, range and Golomb coders, slice counts,
     grey, 4:2:0 and odd sizes) decodes to its manifest's cv2 digests, fps,
     size and count, every recorded seek reads cv2's frame (or nothing,
     as cv2's), H.263 and FFV1 muxed into .ts are refused; (b)
     ``cli/extract_video --mode arrows --batch 4 --dtype bfloat16`` over
     the 13-frame 436x1024 MPEG-2 ``.ts`` (K1 15 a run) and the 3-frame
     FFV1 ``.mkv`` (K1 5); (c) ``cli/train --regime pseudo`` for 2 steps
     over a 10-frame low-delay 436x1024 MPEG-2 ``.ts``: K1 and B1 5 a step;
     (d) host ms to open (demux) and decode a 436x1024 frame, MPEG-2 in
     .mpg, .ts and .m2v, FFV1 in .mkv; (e) no cv2, PIL or jax in
     ``sys.modules``;
 24. H.263+, 16-bit colour PNG sequences and PTS-only transport streams
     (``phase_plus``): (a) those fixtures against cv2's digests, counts
     and seeks, crafted headers of the annexes left out refused; (b) the
     video CLI over the 436x1024 H.263+ AVI: K1 15; (c) 2 pseudo steps
     over its first 9 frames: K1 and B1 5 a step; (d) host ms to decode
     and convert; (e) no cv2, PIL or jax in ``sys.modules``;
 25. lossless intra video (host C++ ``runtime/huffyuv.cpp`` and
     ``runtime/utvideo.cpp``, PNG, raw layouts and Motion JPEG in
     QuickTime; ``phase_lossless``): (a) every fixture of the ``lossless``
     group (HuffYUV, FFVHuff, Ut Video and PNG from cv2's writer in
     .avi/.mkv/.mov, PNG in .mp4, MJPG in .mov, raw Y800/GREY/YV12/RGBA;
     libavcodec's predictors, layouts, classic tables, interlaced lines,
     per-frame tables, slices and BT.709; PNG's flavours; BI_RGB) decodes
     to its manifest's cv2 digests, fps, size and count, every recorded
     seek reads cv2's frame, and crafted headers of the layouts left out
     raise naming item 8; (b) ``cli/extract_video --mode arrows --batch 4
     --dtype bfloat16`` over the 2-frame 436x1024 HuffYUV AVI: K1 5; (c)
     ``cli/train --regime pseudo`` for 2 steps over 9 frames of its
     packets: K1 and B1 5 a step; (d) host ms to decode and to convert a
     436x1024 frame, HuffYUV, Ut Video and PNG in AVI beside FFV1 of the
     same pictures; (e) no cv2, PIL or jax in ``sys.modules``;
 26. MagicYUV, Sorenson H.263 and ASUS V1/V2 (host C++
     ``runtime/magicyuv.cpp``, ``runtime/asv.cpp`` and ``runtime/h263.cpp``'s
     Sorenson reading behind ``io/flv.py`` and the other demuxers;
     ``phase_magy_flv_asv``): (a) every fixture of the ``magicyuv``,
     ``sorenson`` and ``asv`` groups (cv2's writer: M8Y0, ASV1 and ASV2 in
     .avi/.mkv/.mov, FLV1 in .flv/.avi/.mkv/.mov; libavcodec's layouts,
     predictors, escapes and quantisers; rewritten headers) decodes to its
     manifest's cv2 digests, fps, size and count, every recorded seek
     reads cv2's frame, and crafted headers of what is left out raise
     naming item 8; (b) ``cli/extract_video --mode arrows --batch 4
     --dtype bfloat16`` over the 13-frame 436x1024 Sorenson ``.flv``: K1
     15; (c) ``cli/train --regime pseudo`` for 3 steps over the same
     ``.flv``: K1 and B1 5 a step; (d) host ms to decode and to convert a 436x1024 frame of
     MagicYUV, Sorenson and ASV2 beside Ut Video and H.263+; (e) no cv2,
     PIL or jax in ``sys.modules``;
 27. MS-MPEG4 v2/v3 and WMV7/WMV8 (host C++ ``runtime/msmpeg4.cpp``
     behind ``io/asf.py`` and the AVI, Matroska and QuickTime demuxers;
     ``phase_msmpeg4``): (a) every fixture of the ``msmpeg4`` group (cv2's
     writer: MP42, DIV3, WMV1 and WMV2 in .avi/.mkv/.mov/.wmv and .asf,
     ASF at 30000/1001, 24 and 15 fps; libavcodec's four encoders at four
     quantisers, odd sizes, a low rate, hard edges; v3 recoded in DC and
     MV table 0) decodes to its manifest's cv2 digests, fps, size and
     count, every recorded seek reads cv2's frame, and crafted headers of
     what is left out raise naming item 8; (b) ``cli/extract_video --mode
     arrows --batch 4 --dtype bfloat16`` over the 13-frame 436x1024 WMV8
     ``.wmv``: K1 15; (c) ``cli/train --regime pseudo`` for 3 steps over
     the same ``.wmv``: K1 and B1 5 a step; (d) host ms to decode a
     436x1024 frame of v2, v3, WMV7 and WMV8 beside H.263+ and Sorenson,
     and to convert it; (e) no cv2, PIL or jax in ``sys.modules``;
 28. Snow (host C++ ``runtime/snow.cpp`` behind the AVI, Matroska,
     QuickTime and ASF demuxers; ``phase_snow``): (a) every fixture of the
     ``snow`` group (cv2's writer: SNOW in .avi/.mkv/.mov/.wmv, 52x36, 24
     fps; libavcodec's 5/3 wavelet, lossless, qpel, mv4, three references,
     iterative search, key frames only, yuv410p/yuv444p/gray, a quantiser
     ladder, an odd 53x37) decodes to its manifest's cv2 digests, fps, size
     and count, every recorded seek reads cv2's frame, the crafted headers
     of what is left out raise naming item 8, and ``memc_only``'s key
     frames, which FFmpeg refuses, raise; (b) ``cli/extract_video --mode
     arrows --batch 4 --dtype bfloat16`` over the 13-frame 436x1024 Snow
     AVI: K1 15; (c) ``cli/train --regime pseudo`` for 3 steps over the
     same AVI: K1 and B1 5 a step; (d) host ms to decode and to convert a
     436x1024 Snow frame beside MS-MPEG4 v3 and H.263+; (e) no cv2, PIL
     or jax in ``sys.modules``;
 29. NUT and Dirac/VC-2 (``io/nut.py`` and host C++
     ``runtime/dirac.cpp`` behind it and the .drc, AVI, ASF, Matroska,
     QuickTime/MP4 and transport stream demuxers; ``phase_nut_dirac``):
     (a) every fixture of the ``nut`` and ``dirac`` groups (cv2's writer:
     every fourcc the port decodes in .nut, an odd size, 29.97 fps, cv2's
     .nut bytes cut or damaged; drac in .drc/.avi/.mkv/.mov/.mp4/.ts/.nut/
     .wmv, 52x36; libavcodec's vc2 encoder's wavelets, depths, slices,
     matrices, rates, full range, 4:2:2, 4:4:4) decodes to its manifest's
     cv2 digests, fps, size and count, every recorded seek reads cv2's
     frame or, where cv2's reads nothing (a Dirac .nut), raises, and what
     cv2 refuses or the port leaves out raises; (b) ``cli/extract_video
     --mode arrows --batch 4 --dtype bfloat16`` over the 13-frame 436x1024
     VC-2 ``.nut``: K1 15; (c) ``cli/train --regime pseudo`` for 3 steps
     over its packets remuxed into AVI (the .nut itself cannot be sought,
     in cv2 either): K1 and B1 5 a step; (d) host ms to decode and to
     convert a 436x1024 VC-2 frame beside Snow and MS-MPEG4 v3, and NUT's
     demux ms a packet beside AVI's; (e) no cv2, PIL or jax in
     ``sys.modules``;
 30. the writer's containers and the repaired fixtures
     (``io/mp4.py``, ``io/nut.py``, ``io/asf.py``, ``io/mpegps.py``,
     ``io/mpegts.py`` behind ``AsyncVideoWriter``; ``phase_containers``):
     (a) the fixtures the port once refused and cv2 reads (10- and 12-bit
     VC-2, an I-VOP and a P-VOP cut short in .nut, Snow's header fields
     and MC filters) decode to their manifest's cv2 digests, fps, size,
     count and seeks (the cut P-VOP: cv2's 24 frames); the 13-frame 436x1024
     Sintel clip written through ``AsyncVideoWriter`` into each container
     cv2's mp4v writer opens (.mov, .m4v, .3gp, .3g2, .nut, .wmv, .asf,
     .mpg, .mpeg, .vob, .ts, .mts, .m2t, .m2ts) reads back through the
     port's reader to the encoder's reconstruction, with the encode and
     each container's mux timed apart; no cv2, PIL or jax in
     ``sys.modules``; (b) ``cli/extract_video --mode arrows --batch 4
     --dtype bfloat16`` over that clip into .mov and into .ts: K1 15 each,
     fps and the encode thread's ms a frame beside phase 17's .mp4;
 31. JPEG 2000, the tags and raw layouts cv2's writer uses, and P-VOPs cut
     short (``runtime/jpeg2000.cpp`` and ``runtime/mpeg4.cpp``'s error
     concealment behind ``io/video.py``; ``phase_jpeg2000``): (a) every
     fixture of the ``jpeg2000``, ``tag`` and ``cut_vop`` groups (cv2's
     MJ2C writer in .avi/.mkv/.mov/.mp4/.nut/.wmv at 96x64 and 52x36;
     libavcodec's jpeg2000 encoder's 5/3, progression orders, tiles,
     SOP/EPH, layers, codestreams and pixel formats (8-16 bits, alpha,
     palettes); crafted ICT, RCT, POC/COC/QCC and tile-parts; 3IV2,
     LJPG, XVID/DIVX/m1v/m2v1 in QuickTime, raw NV12/Y41B/Y8 and yuv4;
     cut VOPs through guess_mv's search and the spatial path) decodes to
     its manifest's cv2 digests,
     fps, size, count and seeks; (b) ``cli/extract_video --mode arrows
     --batch 4 --dtype bfloat16`` over the 5-frame 436x1024 JPEG 2000 AVI:
     K1 5; (c) ``cli/train --regime pseudo`` for 3 steps over its packets
     cycled to 13 frames in AVI: K1 and B1 5 a step; (d) host ms to decode
     a 436x1024 JPEG 2000 frame (tier 1, the inverse DWT, the output) and
     to convert it, beside VC-2; (e) no cv2, PIL or jax in
     ``sys.modules``;
 32. H.264 (``runtime/h264.cpp`` behind ``io/video.py``; ``phase_h264``):
     (a) every fixture of the ``h264`` group (the syntax writer's streams,
     each in CAVLC and in CABAC, muxed by libavformat into .mp4, .mov,
     .mkv, .avi, .ts, .h264, .nut and .wmv) decodes to its manifest's cv2
     digests, fps, size, count, seeks and libavcodec's planes, and the
     MPEG-4 VOP cut right after its start code to cv2's 24 frames; (b)
     ``cli/extract_video --mode arrows --batch 4 --dtype bfloat16`` over a
     13-frame 436x1024 H.264 .mp4 written at run time (real_im1 in I_PCM,
     then a pan of P_L0_16x16, CABAC): K1 15; (c) ``cli/train --regime
     pseudo`` for 3 steps over it: K1 and B1 5 a step; (d) host ms to
     decode a 436x1024 frame, I and P apart, CAVLC beside CABAC, beside
     MPEG-4 Part 2 on the same frames, and to convert it; (e) no cv2, PIL
     or jax in ``sys.modules``;
 33. H.264 B pictures and rotated tracks (``runtime/h264.cpp``'s B slices,
     ``io/orientation.py``; ``phase_h264_b``): (a) every fixture of the
     ``h264_b`` group (B pyramids, spatial and temporal direct, every B
     type, the three bi-prediction modes, CAVLC and CABAC, in the nine
     containers), of the ``rotation`` group and MPEG-2 under stream type
     0x1B (``relabel``) decodes to its manifest's
     cv2 digests, fps, size, count, seeks and libavcodec's planes; (b)
     ``cli/extract_video --mode arrows --batch 4 --dtype bfloat16`` over a
     13-frame 436x1024 H.264 .mp4 with B pictures written at run time
     (real_im1 in I_PCM, a P picture every third frame panning, B_Skip
     pictures between in temporal direct mode, ``ctts`` and ``elst``): K1
     15; (c) ``cli/train --regime pseudo`` for 3 steps over it: K1 and B1
     5 a step; (d) host ms to decode a 436x1024 B picture (all-skipped
     temporal and spatial, random B macroblocks), CAVLC beside CABAC,
     beside the P pictures, and to convert it; (e) no cv2, PIL or jax in
     ``sys.modules``;
 34. TIFF, JPEG-LS, SpeedHQ and VP9 in enhanced FLV, the census's last
     pairs (``runtime/tiff.cpp``, ``runtime/jpegls.cpp``,
     ``runtime/speedhq.cpp``, ``io/flv.py``; ``phase_census``): (a) every
     fixture of the ``tiff``, ``tiff_seq`` (``%d.tif`` sequences),
     ``jpegls``, ``speedhq`` and ``flv_vp9`` groups decodes to its
     manifest's cv2 digests, fps, size, count and seeks, JPEG-LS to the
     frames written and SpeedHQ to libavcodec's planes; (b)
     ``cli/extract_video --mode arrows --batch 4 --dtype bfloat16`` over a
     ``%06d.tif`` pattern of 13 uncompressed 436x1024 frames written at run
     time from the real pair: K1 15; (c) ``cli/train --regime pseudo`` for
     3 steps over the pattern: K1 and B1 5 a step; (d) host ms to decode a
     436x1024 frame of each new codec (TIFF uncompressed RGB and PackBits
     YCbCr 4:2:0, JPEG-LS, SpeedHQ) and to convert it; (e) no cv2, PIL or
     jax in ``sys.modules``;
 35. one JSON line listing every kernel with its launches on its path,
     error, times and bound; the card's name and power limit; the result
     line.

Each kernel's launch count is set to 0 just before its path and read just
after: the CLI and engine for K1, the probe entry points for K3 and K4, the
training steps for B1 (and K1 there), the eval CLIs (K1), the training
CLI's runs (K1 and B1), the video CLIs' runs (K1), the serving CLI (K1,
counted in its own process from 0) and the parity-mode server's burst, the
loaded artifacts and the parity CLI (K1), each rank's paths of phase 14
(K1 and B1, counted in each rank's process from 0), phase 15's JPEG
paths (K1, and B1 in the pseudo steps), phase 16's compare runs (K1) and
phase 17's MPEG-4 paths, phase 18's Motion JPEG and image-sequence
paths, phase 19's VP8 and Matroska paths, phase 20's VP9 paths,
phase 21's MPEG-1/2 paths, phase 22's H.263 and size-change paths,
phase 23's transport stream and FFV1 paths, phase 24's H.263+ paths,
phase 25's lossless paths, phase 26's MagicYUV, Sorenson and ASV paths,
phase 27's MS-MPEG4/WMV paths, phase 28's Snow paths, phase 29's NUT
and Dirac paths (K1 in the video CLI's runs, K1 and B1 in the pseudo
steps), phase 30's writer paths (K1 in the video CLI's runs), phase
31's JPEG 2000 paths, phase 32's and 33's H.264 paths and phase 34's
TIFF pattern paths (K1 in the video CLI's run, K1 and B1 in the pseudo
steps).
The weights are random: ``tests/oracles/torch_pwcnet.py``'s ``OraclePWC``
from ``torch.manual_seed(0)``, ×0.5 (the recipe the goldens were made with).
The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(ROOT, "tests", "goldens")

MD = 4
ND2 = (2 * MD + 1) ** 2
# (name, H, W, C) of the correlation inputs at each pyramid level of a
# 448x1024 frame (the Sintel 436x1024 padded to /64)
LEVELS = (("L2", 112, 256, 32), ("L3", 56, 128, 64), ("L4", 28, 64, 96),
          ("L5", 14, 32, 128), ("L6", 7, 16, 196))
# the same levels of a 1088x1920 frame (the Pallas windowed kernel's domain)
LEVELS_1080 = (("L2", 272, 480, 32), ("L3", 136, 240, 64),
               ("L4", 68, 120, 96), ("L5", 34, 60, 128),
               ("L6", 17, 30, 196))
# level 2 of 1088x1920, and a shape whose W is not a multiple of the
# kernels' 32-column tile nor H of their 4-row tile
EXTRA_SHAPES = (("L2@1088x1920", 272, 480, 32), ("ragged", 9, 45, 20))
FULL_H, FULL_W = 436, 1024
# the training crop and batch (the JAX cli/train.py defaults --crop 320 896,
# --batch 4) and the correlation inputs at each of its pyramid levels
TRAIN_B, TRAIN_H, TRAIN_W = 4, 320, 896
TRAIN_LEVELS = (("L2", 80, 224, 32), ("L3", 40, 112, 64),
                ("L4", 20, 56, 96), ("L5", 10, 28, 128), ("L6", 5, 14, 196))
KITTI_H, KITTI_W = 375, 1242


def log(msg: str) -> None:
    print(msg, flush=True)


def epe(a, b) -> float:
    import numpy as np
    return float(np.mean(np.hypot(*(a - b).transpose(2, 0, 1))))


def corr_bound(b: int, h: int, w: int, c: int, itemsize: int = 4):
    """Least time for one correlation call on features of ``itemsize``
    bytes: f1 and f2 read once, the 81 maps written once, against the FMAs
    it must do at the float32 rate (bfloat16 features at the tensor cores'
    bfloat16 rate).  Returns (bound_ms, "bytes" | "operations")."""
    from opticalflow_tpu_torch.scripts._timing import (BF16_FLOPS_PER_S,
                                                       FP32_FLOPS_PER_S,
                                                       bound)
    return bound((2 * b * c * h * w + b * ND2 * h * w) * itemsize,
                 2.0 * b * ND2 * c * h * w,
                 FP32_FLOPS_PER_S if itemsize == 4 else BF16_FLOPS_PER_S)


def corr_bwd_bound(b: int, h: int, w: int, c: int, itemsize: int = 4):
    """Least time for one backward call: f1, f2 and the volume's gradient
    read once, d1 and d2 written once, against its 4·81·C·B·H·W operations
    (float32 rate; bfloat16 at the tensor cores' rate, as for K1)."""
    from opticalflow_tpu_torch.scripts._timing import (BF16_FLOPS_PER_S,
                                                       FP32_FLOPS_PER_S,
                                                       bound)
    n = b * h * w
    return bound(itemsize * n * (2 * c + ND2) + itemsize * n * 2 * c,
                 4.0 * ND2 * c * n,
                 FP32_FLOPS_PER_S if itemsize == 4 else BF16_FLOPS_PER_S)


def summed(rows, key_ms="ms"):
    """One forward's worth of per-level rows: the sums of the times and
    bounds, and what bounds the sum."""
    t_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    total = sum(r["bound_ms"] for r in rows)
    extra = {k: sum(r[k] for r in rows) for k in ("device_ms", "host_ms")
             if all(k in r for r in rows)}
    return {"ms": sum(r[key_ms] for r in rows), **extra,
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": total,
            "bound_by": "bytes" if t_bytes >= 0.5 * total else "operations"}


def phase_build():
    from opticalflow_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build(_build.KERNEL_SOURCES)
    log(f"[1] built {len(paths)} kernel(s) in "
        f"{time.perf_counter() - t0:.1f} s")
    assert set(paths) == {"correlation_fwd", "correlation_bwd",
                          "fused_warp_corr", "row_gather"}, sorted(paths)
    # the host codec: phase 11's I420 writers and uploads convert through
    # it, phase 17 encodes and decodes with it
    from opticalflow_tpu_torch.runtime import mpeg4
    t0 = time.perf_counter()
    mpeg4.load()
    log(f"[1] built runtime/mpeg4.cpp (g++) in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        report = path.with_name(path.name + ".ptxas.txt")
        lines = report.read_text().splitlines() if report.exists() else []
        for line in lines:
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")
            if "spill" in line:
                assert "0 bytes spill stores, 0 bytes spill loads" in line, \
                    f"{name} spills: {line.strip()}"


def corr_check(shapes, g, tag: str):
    """K1/K2 against the plain correlation on the card at each (batch,
    (name, H, W, C)) of ``shapes``, float32 and bfloat16, on random inputs;
    fails on any value over the tolerance.  Returns the max abs error by
    dtype."""
    import torch
    from opticalflow_tpu_torch.ops.corr_cuda import correlation_cuda
    from opticalflow_tpu_torch.ops.correlation import correlation_plain
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for b, (name, h, w, c) in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            f1 = torch.randn(b, c, h, w, generator=g, device="cuda").to(dtype)
            f2 = torch.randn(b, c, h, w, generator=g, device="cuda").to(dtype)
            out = correlation_cuda(f1, f2, max_displacement=MD)
            ref = correlation_plain(f1, f2, pad_size=MD,
                                    max_displacement=MD)
            torch.cuda.synchronize()
            assert out.shape == ref.shape == (b, ND2, h, w), out.shape
            assert out.dtype == dtype
            err = (out.float() - ref).abs()
            if dtype == torch.float32:
                # float32 sums of <=196 products in another order
                tol = torch.full_like(ref, 1e-5)
            else:
                # one bf16 rounding of the float32 sum: 2^-9 relative,
                # doubled for the plain version's summation order
                tol = ref.abs() * 2.0 ** -8 + 1e-6
            bad = int((err > tol).sum())
            e = float(err.max())
            worst[dtype] = max(worst[dtype], e)
            log(f"{tag} {name:13s} B={b} {str(dtype)[6:]:8s} ({h}x{w}x{c}) "
                f"max|kernel-plain| {e:.3e}" + ("" if not bad else
                                                 f"  {bad} OVER TOLERANCE"))
            assert bad == 0, f"kernel disagrees with plain at {name} {dtype}"
            del f1, f2, out, ref, err, tol
    return worst


def phase_corr_vs_plain():
    """K1/K2 against the plain version, then timed.  Returns (max f32
    error, 448x1024 rows, 1088x1920 rows, bfloat16 rows)."""
    import torch
    from opticalflow_tpu_torch.ops.corr_cuda import (correlation_cuda,
                                                     launch_plan)
    from opticalflow_tpu_torch.ops.correlation import correlation_plain
    from opticalflow_tpu_torch.scripts._timing import (cuda_ms, device_ms,
                                                       host_ms)

    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(b, s) for b in (1, 8) for s in LEVELS] + [
        (1, s) for s in EXTRA_SHAPES]
    worst = corr_check(shapes, g, "[2]")

    def time_levels(levels, batches, frame, dtype=torch.float32):
        rows = []
        for b in batches:
            for name, h, w, c in levels:
                f1 = torch.randn(b, c, h, w, generator=g,
                                 device="cuda").to(dtype)
                f2 = torch.randn(b, c, h, w, generator=g,
                                 device="cuda").to(dtype)

                def call(_):
                    return correlation_cuda(f1, f2, max_displacement=MD)

                # the channel split is reduced in a fixed order: two runs
                # give the same bits
                same_bits = torch.equal(call(0), call(1))
                assert same_bits, f"two runs differ at {frame} {name} B={b}"
                plan = launch_plan(b, c, h, w, dtype)
                k_ms = cuda_ms(call, 200)       # back to back from Python
                d_ms = device_ms(call, 200)     # the card alone
                h_ms = host_ms(call, 200)       # the host's time to queue one
                p_ms = cuda_ms(lambda _: correlation_plain(
                    f1, f2, pad_size=MD, max_displacement=MD), 10)
                bound_ms, bound_by = corr_bound(b, h, w, c,
                                                f1.element_size())
                rows.append({"level": name, "frame": frame, "batch": b,
                             "dtype": str(dtype)[6:], "shape": [h, w, c],
                             "ms": k_ms, "device_ms": d_ms, "host_ms": h_ms,
                             "plain_ms": p_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "same_bits": same_bits,
                             **plan})
                log(f"[2] time {frame} {name} B={b} {str(dtype)[6:]}: card "
                    f"alone {d_ms * 1e3:.2f} us  events {k_ms * 1e3:.2f} us  "
                    f"host {h_ms * 1e3:.2f} us  plain {p_ms * 1e3:.2f} us  "
                    f"bound {bound_ms * 1e3:.3f} us ({bound_by})  tile "
                    f"{plan['tile'][0]}x{plan['tile'][1]} grid "
                    f"{plan['grid']} split {plan['split']} "
                    f"({plan['channels_per_split']} ch) smem "
                    f"{plan['smem_bytes']} B  two runs bit-equal")
        return rows

    rows = time_levels(LEVELS, (1, 8), "448x1024")
    rows_1080 = time_levels(LEVELS_1080, (1,), "1088x1920")
    rows_bf16 = (time_levels(LEVELS, (1, 8), "448x1024", torch.bfloat16)
                 + time_levels(LEVELS_1080, (1,), "1088x1920",
                               torch.bfloat16))
    for what, sel in (("448x1024 B=1", [r for r in rows if r["batch"] == 1]),
                      ("448x1024 B=8", [r for r in rows if r["batch"] == 8]),
                      ("1088x1920 B=1", rows_1080)):
        log(f"[2] one forward's 5 levels, {what} f32: card alone "
            f"{sum(r['device_ms'] for r in sel) * 1e3:.2f} us, events "
            f"{sum(r['ms'] for r in sel) * 1e3:.2f} us, host "
            f"{sum(r['host_ms'] for r in sel) * 1e3:.2f} us, bound "
            f"{sum(r['bound_ms'] for r in sel) * 1e3:.3f} us")
    log(f"[2] max abs error: float32 {worst[torch.float32]:.3e}, "
        f"bfloat16 {worst[torch.bfloat16]:.3e}")
    return worst[torch.float32], rows, rows_1080, rows_bf16


def phase_fused_vs_plain():
    """K3 against its plain version.  Returns (max float32 error, max
    bfloat16 error, output pixels excluded for a mask sum within 1e-6 of
    the threshold)."""
    import torch
    import torch.nn.functional as F
    from opticalflow_tpu_torch.ops.fused_warpcorr import (
        fused_warp_corr_cuda, fused_warp_corr_plain, prep_gather)

    g = torch.Generator(device="cuda").manual_seed(3)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    excluded = 0
    shapes = [(b, s) for b in (1, 8) for s in LEVELS[:4]] + [
        (1, s) for s in EXTRA_SHAPES]
    for b, (name, h, w, c) in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            f1 = torch.randn(b, c, h, w, generator=g, device="cuda").to(dtype)
            f2 = torch.randn(b, c, h, w, generator=g, device="cuda").to(dtype)
            for px in (3.0, 20.0):
                flow = torch.randn(b, 2, h, w, generator=g,
                                   device="cuda") * px
                for thr in (0.9999, 0.999):
                    out = fused_warp_corr_cuda(f1, f2, flow,
                                               mask_threshold=thr)
                    # the plain version in float32, before the rounding to
                    # the features' dtype
                    ref = fused_warp_corr_plain(f1.float(), f2.float(), flow,
                                                mask_threshold=thr)
                    torch.cuda.synchronize()
                    assert out.shape == (b, ND2, h, w) and out.dtype == dtype
                    # a warped pixel whose mask sum is within 1e-6 of thr
                    # may decide otherwise; exclude the outputs it reaches
                    _, _, wv = prep_gather(flow, h, w, 0.0)
                    near = ((wv.sum(1, keepdim=True) - thr).abs()
                            < 1e-6).float()
                    reach = F.max_pool2d(near, 2 * MD + 1, 1, MD) > 0
                    n_excl = int(reach.sum())
                    excluded += n_excl
                    err = ((out.float() - ref).abs()
                           * (~reach).float())
                    if dtype == torch.float32:
                        # float32 sums of <=128 products and of the corner
                        # terms, in another order
                        tol = torch.full_like(ref, 1e-4)
                    else:
                        # one bf16 rounding of the float32 result, doubled
                        # for the order
                        tol = ref.abs() * 2.0 ** -8 + 1e-5
                    bad = int((err > tol).sum())
                    e = float(err.max())
                    worst[dtype] = max(worst[dtype], e)
                    log(f"[3] {name:13s} B={b} {str(dtype)[6:]:8s} "
                        f"({h}x{w}x{c}) flow x{px:g} thr {thr}: "
                        f"max|kernel-plain| {e:.3e}, {n_excl} excluded"
                        + (f"  {bad} OVER TOLERANCE" if bad else ""))
                    assert bad == 0, (f"fused kernel disagrees with plain at "
                                      f"{name} {dtype} x{px} {thr}")
    log(f"[3] max abs error: float32 {worst[torch.float32]:.3e}, bfloat16 "
        f"{worst[torch.bfloat16]:.3e}; output pixels excluded (mask sum "
        f"within 1e-6 of the threshold): {excluded}")
    return worst[torch.float32], worst[torch.bfloat16], excluded


def phase_gather_vs_plain():
    """K4 against its plain version, exact, NaN rows included; then timed
    beside the plain version at the probe's shape, and at one row.  Returns
    (max error, plain ms, one-row ms on the card alone)."""
    import torch
    from opticalflow_tpu_torch.ops.gather import (row_gather_cuda,
                                                  row_gather_plain)
    from opticalflow_tpu_torch.scripts import probe_gather
    from opticalflow_tpu_torch.scripts._timing import cuda_ms, device_ms

    g = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    for n, m, c in ((probe_gather.N, probe_gather.M, probe_gather.C),
                    (37, 300, 21), (5, 64, 3), (1000, 100000, 64)):
        x = torch.randn(n, c, generator=g, device="cuda")
        idx = torch.randint(-2 * n, 2 * n, (m, 1), generator=g,
                            device="cuda", dtype=torch.int32)
        out = row_gather_cuda(x, idx)
        ref = row_gather_plain(x, idx)
        torch.cuda.synchronize()
        nan_rows = int(torch.isnan(ref).all(1).sum())
        same_nan = torch.equal(torch.isnan(out), torch.isnan(ref))
        err = float((torch.nan_to_num(out) - torch.nan_to_num(ref))
                    .abs().max())
        log(f"[4] row_gather N={n} M={m} C={c}: max|kernel-plain| {err}, "
            f"NaN rows {nan_rows} (same: {same_nan})")
        assert same_nan and err == 0.0 and nan_rows > 0
        worst = max(worst, err)
    x = torch.randn(probe_gather.N, probe_gather.C, generator=g,
                    device="cuda")
    idx = torch.randint(0, probe_gather.N, (probe_gather.M, 1), generator=g,
                        device="cuda", dtype=torch.int32)
    plain_ms = cuda_ms(lambda _: row_gather_plain(x, idx), 50)
    log(f"[4] row_gather_plain at the probe's shape: {plain_ms * 1e3:.2f} us")
    # what any launch through ops/_launch.py costs the card: one row
    one = idx[:1].contiguous()
    floor_ms = device_ms(lambda _: row_gather_cuda(x, one), 200)
    log(f"[4] launch floor: row_gather_cuda of 1 row x {probe_gather.C} "
        f"float32, card alone {floor_ms * 1e3:.2f} us (every B=1 time above "
        f"contains one)")
    return worst, plain_ms, floor_ms


def fake_reference_checkpoint(path: str):
    """Write the golden recipe's weights as a reference-layout checkpoint
    (``module.`` prefixes and the dead ``deconv2`` included); returns the
    state dict."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracles.torch_pwcnet import OraclePWC
    torch.manual_seed(0)
    net = OraclePWC(variant="new")
    for p in net.parameters():
        p.data *= 0.5
    sd = net.state_dict_flat()
    checksum = sum(float(v.double().abs().sum()) for v in sd.values())
    log(f"[5] fake weights: {len(sd)} tensors, sum|w| = {checksum!r}")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)
    return sd


def phase_cli(tmp: str, counter):
    from opticalflow_tpu_torch.cli import script_pwc
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.io.flo import read_flo
    from opticalflow_tpu_torch.io.images import load_image
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    sd = fake_reference_checkpoint(ckpt)
    im1, im2 = (os.path.join(GOLD, f"real_im{i}.png") for i in (1, 2))
    engine = FlowEngine(PWCDCNet(), sd, flow_scale=1.0, device="cuda")
    runs = (
        ("CLI pad/rgb_imagenet", "real_pair_pad.flo",
         ["--size-mode", "pad", "--preset", "rgb_imagenet",
          "--flow-scale", "1.0"]),
        # the CLI's default size mode
        ("CLI resize/bgr_unit", "real_pair.flo",
         ["--preset", "bgr_unit", "--flow-scale", "20"]),
        ("FlowEngine pad_ref/rgb_imagenet", "real_pair_padref.flo", None))
    for what, golden, flags in runs:
        before = counter.launches
        if flags is None:
            flow = engine.flow_from_pair(load_image(im1), load_image(im2),
                                         preset="rgb_imagenet",
                                         size_mode="pad_ref")
        else:
            out = os.path.join(tmp, golden)
            rc = script_pwc.main([im1, im2, out, "--ckpt", ckpt,
                                  "--device", "cuda", *flags])
            assert rc == 0, rc
            flow = read_flo(out)
        launched = counter.launches - before
        assert launched == 5, f"one forward must launch the kernel 5 " \
                              f"times, got {launched}"
        ref = read_flo(os.path.join(GOLD, golden))
        assert flow.shape == ref.shape == (180, 318, 2), flow.shape
        d = epe(flow, ref)
        log(f"[5] {what} vs {golden}: mean EPE delta {d:.3e} (bound 1e-4, "
            f"TF32 off); kernel launches {launched}")
        assert d <= 1e-4, f"{what} off the golden: {d:.3e}"
    assert "cv2" not in sys.modules, "the port imported OpenCV"
    return sd


def phase_full_width(sd, counter):
    import numpy as np
    import torch
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.io import images as imio
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet

    engine = FlowEngine(PWCDCNet(), sd, flow_scale=20.0, device="cuda")
    results = {}
    for mode in ("pad", "resize"):
        rng = np.random.RandomState(0)
        flows = {}
        for b, n_batches in ((1, 20), (8, 5)):
            im1s = rng.randint(0, 256, (b, FULL_H, FULL_W, 3), np.uint8)
            # frame 2 = frame 1 shifted by (3, 5) px plus noise: coherent
            # motion
            im2s = np.roll(im1s, (3, 5), axis=(1, 2))
            im2s = np.clip(im2s + rng.randint(-8, 9, im2s.shape), 0,
                           255).astype(np.uint8)

            def run():
                return engine.flow_from_pairs(list(im1s), list(im2s),
                                              preset="bgr_unit",
                                              size_mode=mode)

            before = counter.launches
            run()                                    # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            lat = []
            t0 = time.perf_counter()
            for _ in range(n_batches):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                flow = run()                         # returns host numpy
                e.record()
                e.synchronize()
                lat.append(s.elapsed_time(e))
            wall = time.perf_counter() - t0
            launched = counter.launches - before
            assert launched == 5 * (n_batches + 1), launched
            assert flow.shape == (b, FULL_H, FULL_W, 2), flow.shape
            assert np.isfinite(flow).all(), "non-finite flow"
            flows[b] = flow
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            lat_ms = float(np.median(lat))
            results[(mode, b)] = {
                "pairs_per_s": b * n_batches / wall,
                "batch_ms_median": lat_ms, "per_pair_ms": lat_ms / b,
                "peak_mib": peak}
            log(f"[6] FlowEngine {mode} 436x1024 f32 B={b}: "
                f"{b * n_batches / wall:.2f} pairs/s, call latency median "
                f"{lat_ms:.3f} ms ({lat_ms / b:.3f} ms/pair, CUDA events "
                f"around flow_from_pairs incl. host resize/pad and "
                f"H2D/D2H), peak {peak:.0f} MiB")
        # the same pair alone and inside a batch of 8 (the last loop's)
        d = epe(flows[8][0], engine.flow_from_pair(
            im1s[0], im2s[0], preset="bgr_unit", size_mode=mode))
        log(f"[6] {mode}: B=8 row 0 vs B=1 run of the same pair: mean EPE "
            f"delta {d:.3e}")
        assert d <= 1e-4, d
    frame = np.random.RandomState(1).randint(0, 256, (FULL_H, FULL_W, 3),
                                             np.uint8)
    t0 = time.perf_counter()
    for _ in range(20):
        imio.resize_to_multiple_of_64(frame)
    resize_ms = (time.perf_counter() - t0) / 20 * 1e3
    log(f"[6] host resize_to_multiple_of_64 436x1024 -> 448x1024 uint8: "
        f"{resize_ms:.3f} ms per frame (host clock, 20 frames; a pair "
        f"needs two)")
    assert "cv2" not in sys.modules, "the port imported OpenCV"
    return engine, results


def phase_forward_time(engine):
    """Device time of the network forward alone (no host transfers)."""
    import torch
    from opticalflow_tpu_torch.scripts._timing import cuda_ms
    out = {}
    for b in (1, 8):
        x = torch.rand(b, 6, 448, 1024, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(1))
        with torch.inference_mode():
            out[b] = cuda_ms(lambda _: engine.model(x), 10 if b == 8 else 30)
        log(f"[6] forward alone 448x1024 f32 B={b}: {out[b]:.3f} ms "
            f"({out[b] / b:.3f} ms/pair)")
    return out


def phase_corr_bwd():
    """B1 against its plain version at every training and 448x1024 level,
    float32 and bfloat16, two runs bit-equal; then timed per level.
    Returns (max float32 error, max bfloat16 error, rows)."""
    import torch
    from opticalflow_tpu_torch.ops.corr_cuda import (bwd_launch_plan,
                                                     correlation_bwd_cuda)
    from opticalflow_tpu_torch.ops.correlation import correlation_bwd_plain
    from opticalflow_tpu_torch.scripts._timing import cuda_ms, device_ms

    g = torch.Generator(device="cuda").manual_seed(7)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rows = []
    shapes = ([(TRAIN_B, s, "320x896") for s in TRAIN_LEVELS]
              + [(1, s, "448x1024") for s in LEVELS])
    for b, (name, h, w, c), frame in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            f1, f2 = (torch.randn(b, c, h, w, generator=g,
                                  device="cuda").to(dtype) for _ in range(2))
            gv = torch.randn(b, ND2, h, w, generator=g,
                             device="cuda").to(dtype)

            def call(_):
                return correlation_bwd_cuda(f1, f2, gv, max_displacement=MD)

            got = call(0)
            ref = correlation_bwd_plain(f1, f2, gv, max_displacement=MD)
            again = call(1)
            torch.cuda.synchronize()
            same_bits = all(torch.equal(a, r) for a, r in zip(got, again))
            err = max(float((a.float() - r.float()).abs().max())
                      for a, r in zip(got, ref))
            scale = max(float(r.float().abs().max()) for r in ref)
            # float32: sums of 81 products in another order (fma against a
            # rounded product); bfloat16: one bf16 rounding of the float32
            # sum in either version, 2^-8 relative
            tol = (1e-5 if dtype == torch.float32 else 1e-2) * scale
            worst[dtype] = max(worst[dtype], err)
            plan = bwd_launch_plan(b, c, h, w, dtype)
            d_ms = device_ms(call, 100)
            k_ms = cuda_ms(call, 100)
            p_ms = cuda_ms(lambda _: correlation_bwd_plain(
                f1, f2, gv, max_displacement=MD), 3)
            bound_ms, bound_by = corr_bwd_bound(b, h, w, c,
                                                f1.element_size())
            dt = str(dtype)[6:]
            rows.append({"level": name, "frame": frame, "batch": b,
                         "dtype": dt, "shape": [h, w, c], "ms": k_ms,
                         "device_ms": d_ms, "plain_ms": p_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "max_abs_err": err, "max_abs_grad": scale,
                         "same_bits": same_bits, **plan})
            log(f"[7] {frame} {name} B={b} {dt:8s} ({h}x{w}x{c}) "
                f"max|kernel-plain| {err:.3e} (max|grad| {scale:.3e}, "
                f"bound {tol:.1e}); two runs bit-equal: {same_bits}; card "
                f"alone {d_ms * 1e3:.2f} us  events {k_ms * 1e3:.2f} us  "
                f"plain {p_ms * 1e3:.2f} us  bound {bound_ms * 1e3:.3f} us "
                f"({bound_by})  tile {plan['tile'][0]}x{plan['tile'][1]} "
                f"grid {plan['grid']} split {plan['split']} "
                f"({plan['channels_per_split']} ch) {plan['threads']} "
                f"threads, {plan['blocks_per_sm']} blocks/SM, "
                f"{plan['registers']} registers")
            assert err <= tol, f"B1 disagrees with plain at {frame} {name} " \
                               f"{dt}: {err:.3e} > {tol:.3e}"
            assert same_bits, f"two B1 runs differ at {frame} {name} {dt}"
    for frame, b in (("320x896", TRAIN_B), ("448x1024", 1)):
        for dt in ("float32", "bfloat16"):
            sel = [r for r in rows if r["frame"] == frame
                   and r["dtype"] == dt]
            log(f"[7] one step's 5 levels, {frame} B={b} {dt}: card alone "
                f"{sum(r['device_ms'] for r in sel) * 1e3:.2f} us, events "
                f"{sum(r['ms'] for r in sel) * 1e3:.2f} us, plain "
                f"{sum(r['plain_ms'] for r in sel) * 1e3:.2f} us, bound "
                f"{sum(r['bound_ms'] for r in sel) * 1e3:.3f} us")
    log(f"[7] max abs error: float32 {worst[torch.float32]:.3e}, bfloat16 "
        f"{worst[torch.bfloat16]:.3e}")
    return worst[torch.float32], worst[torch.bfloat16], rows


def train_batch(seed: int = 0):
    """A seeded batch in the JAX layout: frame 2 is frame 1 (a smooth random
    texture) moved by (5, 3) px plus noise, the GT flow that motion, ~20%
    of the pixels invalid."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    rng = np.random.RandomState(seed)
    coarse = torch.from_numpy(rng.rand(TRAIN_B, 3, TRAIN_H // 8,
                                       TRAIN_W // 8).astype(np.float32))
    im1 = F.interpolate(coarse, size=(TRAIN_H, TRAIN_W), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    im2 = np.roll(im1, (3, 5), axis=(1, 2))
    im2 = np.clip(im2 + rng.randn(*im2.shape).astype(np.float32) * 0.02,
                  0.0, 1.0)
    flow = np.broadcast_to(np.array([5.0, 3.0], np.float32),
                           (TRAIN_B, TRAIN_H, TRAIN_W, 2)).copy()
    return {"images": np.concatenate([im1, im2], -1).astype(np.float32),
            "flow": flow,
            "valid": (rng.rand(TRAIN_B, TRAIN_H, TRAIN_W) > 0.2).astype(
                np.float32)}


def phase_train(sd, corr_fwd, corr_bwd):
    """The training step at full width on the card.  Returns a dict of its
    results."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.models.torch_import import reference_state_dict
    from opticalflow_tpu_torch.train import trainer as T

    batch = train_batch()
    sd = reference_state_dict(sd)

    def grads_of(precision, use_cuda_corr):
        """The raw gradients of one parity-mode step (clip off, SGD at lr 0:
        the gradients stay on the parameters) and their launches."""
        model = PWCDCNet(precision=precision, use_cuda_corr=use_cuda_corr)
        model.load_state_dict(sd)
        model = model.cuda()
        cfg = T.TrainConfig(loss="multiscale", grad_clip=0.0)
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        state = T.TrainState(step=0, model=model, optimizer=opt)
        f0, b0 = corr_fwd.launches, corr_bwd.launches
        _, m = T.make_train_step(model, opt, cfg)(state, batch)
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        return grads, float(m["loss"]), (corr_fwd.launches - f0,
                                         corr_bwd.launches - b0)

    def worst_ratio(ga, gb):
        """max over parameters of max|a - b| / max|b|, and its name; a
        parameter whose gradient vanishes (below a millionth of the model's
        largest: rounding noise only) is measured against that millionth."""
        top = max(float(g.abs().max()) for g in gb.values())
        return max(((float((ga[n] - gb[n]).abs().max())
                     / max(float(gb[n].abs().max()), 1e-6 * top)), n)
                   for n in gb)

    g_kernel, loss_k, launched_k = grads_of("highest", True)
    g_again, _, _ = grads_of("highest", True)
    g_plain, loss_p, launched_p = grads_of("highest", False)
    assert launched_k == (5, 5), launched_k
    assert launched_p == (0, 0), launched_p
    ratio, name = worst_ratio(g_kernel, g_plain)
    floor, fname = worst_ratio(g_again, g_kernel)
    log(f"[8] parity mode, 4x320x896 multiscale: loss through K1+B1 "
        f"{loss_k!r}, through the plain correlation {loss_p!r}; worst "
        f"parameter max|grad(K1+B1) - grad(plain)| / max|grad| = "
        f"{ratio:.3e} ({name}; bound 1e-3); the same step twice through "
        f"K1+B1: {floor:.3e} ({fname})")
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), (loss_k, loss_p)
    assert ratio <= 1e-3, f"K1+B1 gradients off the plain ones: {ratio:.3e}"

    # 10 fast-mode steps overfitting the batch (the JAX CLI's precision)
    model = PWCDCNet(precision="fast")
    model.load_state_dict(sd)
    model = model.cuda()
    cfg = T.TrainConfig(loss="multiscale", optimizer="adamw", lr=1e-4,
                        weight_decay=1e-4, grad_clip=1.0)
    state, opt = T.create_train_state(model, cfg)
    step = T.make_train_step(model, opt, cfg)
    dev_batch = T.batch_to_device(batch, torch.device("cuda"))
    dev_batch = {k: v.permute(0, 2, 3, 1).contiguous() if v.dim() == 4
                 else v for k, v in dev_batch.items()}   # NHWC, on the card
    corr_fwd.launches = corr_bwd.launches = 0   # the training path starts
    losses, ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, dev_batch)
        losses.append(float(m["loss"]))         # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    launched = (corr_fwd.launches, corr_bwd.launches)  # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    step_ms = float(np.median(ms[1:]))
    log(f"[8] fast mode, 10 steps: losses {[round(x, 6) for x in losses]}; "
        f"K1/B1 launches {launched}; ms per step {[round(x, 2) for x in ms]}"
        f" (median after the first {step_ms:.2f} ms, "
        f"{TRAIN_B / step_ms * 1e3:.2f} pairs/s; batch already on the "
        f"card); peak {peak:.0f} MiB")
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
    assert launched == (50, 50), launched
    return {"grad_ratio_vs_plain": ratio, "grad_ratio_run_to_run": floor,
            "loss_kernel": loss_k, "loss_plain": loss_p, "losses": losses,
            "step_ms": ms, "step_ms_median": step_ms,
            "pairs_per_s": TRAIN_B / step_ms * 1e3, "peak_mib": peak,
            "launches": {"correlation_fwd": launched[0],
                         "correlation_bwd": launched[1]}}


def write_png(path: str, img) -> None:
    from opticalflow_tpu_torch.io.images import encode_png
    with open(path, "wb") as f:
        f.write(encode_png(img))


def moving_pair(rng, h: int, w: int):
    """A uint8 frame pair: a smooth random texture, then the same moved by
    (3, 5) px plus noise."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    coarse = torch.from_numpy(rng.rand(1, 3, h // 8 + 1,
                                       w // 8 + 1).astype(np.float32))
    im1 = (F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=False)[0].permute(1, 2, 0).numpy()
           * 255).astype(np.uint8)
    im2 = np.roll(im1, (3, 5), axis=(0, 1)).astype(np.int16)
    im2 = np.clip(im2 + rng.randint(-6, 7, im2.shape), 0, 255)
    return im1, im2.astype(np.uint8)


def run_cli(main, argv):
    """Run a CLI's main(argv); returns (rc, mean EPE it printed, wall s)."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    sys.stdout.write(text)
    mean = [float(line.split(":")[1]) for line in text.splitlines()
            if line.startswith("Mean EPE:")]
    return rc, (mean[-1] if mean else float("nan")), wall


# evaluation's timed window: the synthetic 3-pair trees read this many times
# over, so the producer's start and the pipeline's fill are a small share
EVAL_REPS = 16


class Repeated:
    """``dataset`` read ``reps`` times over (its samples decoded anew on
    every read)."""

    def __init__(self, dataset, reps: int):
        self.dataset, self.reps = dataset, reps

    def __len__(self):
        return len(self.dataset) * self.reps

    def __getitem__(self, i: int):
        return self.dataset[i % len(self.dataset)]


def eval_rate(engine, dataset, **kw):
    """``evaluate_pairs`` at batch 2, warm, timed over ``EVAL_REPS`` reads
    of ``dataset``; beside it the host's decode of one sample alone and the
    engine's time a pair alone (B=2 calls on decoded frames), which say
    whether decode overlaps the card.  Returns (result, rates)."""
    import torch
    from opticalflow_tpu_torch.evaluate import evaluate_pairs
    evaluate_pairs(engine, dataset, batch=2, verbose=False, **kw)  # warm-up
    window = Repeated(dataset, EVAL_REPS)
    t0 = time.perf_counter()
    res = evaluate_pairs(engine, window, batch=2, verbose=False, **kw)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    samples = [dataset[i] for i in range(len(dataset))]
    decode_ms = (time.perf_counter() - t0) / len(samples) * 1e3
    ims = ([samples[0]["im1"], samples[1]["im1"]],
           [samples[0]["im2"], samples[1]["im2"]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EVAL_REPS):
        engine.flow_from_pairs(*ims, **kw)
    engine_ms = (time.perf_counter() - t0) / (2 * EVAL_REPS) * 1e3
    return res, {"pairs": len(window), "pairs_per_s": len(window) / wall,
                 "decode_ms": decode_ms, "engine_ms": engine_ms}


def write_kitti_eval_tree(kroot: str, sd, rng) -> None:
    """A KITTI 2015 tree of 3 moving pairs of 375x1242, its 16-bit GT from
    the eval CLI's own settings at batch 1, ~30% of it invalid."""
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.io.kitti import write_flow_png
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    for d in ("image_2", "flow_occ"):
        os.makedirs(os.path.join(kroot, "training", d))
    gt_engine = FlowEngine(PWCDCNet(), sd, flow_scale=1.0, device="cuda")
    for i in range(3):
        im1, im2 = moving_pair(rng, KITTI_H, KITTI_W)
        for k, im in ((10, im1), (11, im2)):
            write_png(os.path.join(kroot, "training", "image_2",
                                   f"{i:06d}_{k}.png"), im)
        flow = gt_engine.flow_from_pair(im1, im2, preset="rgb_imagenet",
                                        size_mode="pad")
        write_flow_png(os.path.join(kroot, "training", "flow_occ",
                                    f"{i:06d}_10.png"), flow,
                       rng.rand(KITTI_H, KITTI_W) > 0.3)


def phase_eval(sd, tmp, corr_fwd):
    """Evaluation through both CLIs on synthetic KITTI and Sintel trees.
    Returns a dict of its results."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.cli import eval_sintel, infer_kitti
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.data.datasets import KittiPairsEval, SintelPairs
    from opticalflow_tpu_torch.io.flo import read_flo, write_flo
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet

    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    rng = np.random.RandomState(9)
    out = {}

    kroot = os.path.join(tmp, "kitti")
    write_kitti_eval_tree(kroot, sd, rng)
    before = corr_fwd.launches
    rc, printed, wall = run_cli(infer_kitti.main, [
        "--root", kroot, "--ckpt", ckpt, "--size-mode", "pad", "--batch",
        "2", "--device", "cuda"])
    launched = corr_fwd.launches - before
    assert rc == 0 and launched == 10, (rc, launched)
    log(f"[9] cli/infer_kitti, 3 pairs 375x1242 at batch 2: mean EPE "
        f"printed {printed} (bound 0.02, the PNG's 1/64 px); {wall:.2f} s "
        f"wall, model load and first call included; K1 launches {launched}")
    assert printed <= 0.02, printed
    engine = FlowEngine(PWCDCNet(), sd, flow_scale=1.0, device="cuda")
    res, rate = eval_rate(engine, KittiPairsEval(kroot), preset="rgb_imagenet",
                          size_mode="pad")
    log(f"[9] evaluate_pairs on KittiPairsEval, warm, {rate['pairs']} pairs "
        f"(the 3 read {EVAL_REPS}x over) at batch 2: EPE {res['epe']!r}, "
        f"Fl-all {res['fl_all']!r}%, {rate['pairs_per_s']!r} pairs/s (PNG "
        f"decode, pad, forward, upsample, metrics); alone: host decode "
        f"{rate['decode_ms']!r} ms a sample (two frames and the 16-bit GT), "
        f"engine {rate['engine_ms']!r} ms a pair (B=2 flow_from_pairs on "
        f"decoded frames)")
    assert res["epe"] <= 0.02, res
    out["kitti"] = {"epe_printed": printed, "epe": res["epe"],
                    "fl_all": res["fl_all"], **rate}

    # Sintel: two sequences (3 and 2 frames: 3 pairs), .flo GT at batch 1
    sroot = os.path.join(tmp, "sintel")
    gt20 = FlowEngine(PWCDCNet(), sd, flow_scale=20.0, device="cuda")
    for seq, n in (("alley_1", 3), ("market_2", 2)):
        os.makedirs(os.path.join(sroot, "training", "clean", seq))
        os.makedirs(os.path.join(sroot, "training", "flow", seq))
        frames = [moving_pair(rng, FULL_H, FULL_W)[0]]
        for _ in range(n - 1):
            nxt = np.roll(frames[-1], (3, 5), axis=(0, 1))
            frames.append(nxt)
        for k, im in enumerate(frames, start=1):
            write_png(os.path.join(sroot, "training", "clean", seq,
                                   f"frame_{k:04d}.png"), im)
        for k in range(1, n):
            write_flo(os.path.join(sroot, "training", "flow", seq,
                                   f"frame_{k:04d}.flo"),
                      gt20.flow_from_pair(frames[k - 1], frames[k],
                                          preset="bgr_unit",
                                          size_mode="pad"))
    save = os.path.join(tmp, "sintel_out")
    before = corr_fwd.launches
    rc, printed, wall = run_cli(eval_sintel.main, [
        "--root", sroot, "--ckpt", ckpt, "--batch", "2", "--save-dir", save,
        "--device", "cuda"])
    launched = corr_fwd.launches - before
    assert rc == 0 and launched == 10, (rc, launched)
    # the saved .flo files against the GT, unrounded
    epes = []
    for seq, n in (("alley_1", 3), ("market_2", 2)):
        for k in range(1, n):
            pred = read_flo(os.path.join(save, f"{seq}_frame_{k:04d}.flo"))
            ref = read_flo(os.path.join(sroot, "training", "flow", seq,
                                        f"frame_{k:04d}.flo"))
            epes.append(epe(pred, ref))
    log(f"[9] cli/eval_sintel, 3 pairs 436x1024 at batch 2: mean EPE "
        f"printed {printed}, from its saved .flo files "
        f"{float(np.mean(epes))!r} "
        f"(bound 1e-3: GT from batch-1 calls); {wall:.2f} s wall; K1 "
        f"launches {launched}")
    assert max(epes) < 1e-3, epes
    res, rate = eval_rate(gt20, SintelPairs(sroot), preset="bgr_unit",
                          size_mode="pad")
    log(f"[9] evaluate_pairs on SintelPairs, warm, {rate['pairs']} pairs at "
        f"batch 2: EPE {res['epe']!r}, {rate['pairs_per_s']!r} pairs/s; "
        f"alone: host decode {rate['decode_ms']!r} ms a sample (two frames "
        f"and the .flo), engine {rate['engine_ms']!r} ms a pair")
    assert res["epe"] < 1e-3, res
    out["sintel"] = {"epe_printed": printed, "epe_saved": float(np.mean(epes)),
                     "epe": res["epe"], **rate}
    assert "cv2" not in sys.modules, "the port imported OpenCV"
    return out


# ------------------------------------------------------------ phase 10

# the training CLI's run: 16 temporal KITTI pairs (val 4, train 12: 3 steps
# an epoch at batch 4) over 2 epochs; the epipolar run: 12 frame pairs
TRAIN_PAIRS = 16
STEADY_EPOCHS = 4
# the uninterrupted runs whose pairwise spread sets the resumed run's
# trajectory tolerance (the first also hashes its batches); six, because
# the runs' final parameters fall into a few clusters (now and then a run
# ends apart from the rest, in one convolution's weights), which three
# runs often miss
UNINTERRUPTED = ("uninterrupted", "again", "third", "fourth", "fifth",
                 "sixth")
EPI_FRAMES = 13


def moving_frames(rng, n: int, h: int, w: int, step=(1.5, 2.5),
                  zoom: float = 1.004):
    """``n`` uint8 frames of one smooth random texture seen by a camera that
    moves sideways by ``step`` px (rows, columns) a frame and forward (the
    view shrinks by ``zoom`` a frame about its moving centre): each frame is
    a window of the texture resized to (h, w) by the port's resize."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from opticalflow_tpu_torch.io.images import resize_bilinear_u8
    bh, bw = h + 64 + int(n * step[0]), w + 64 + int(n * step[1])
    coarse = torch.from_numpy(rng.rand(1, 3, bh // 10 + 2,
                                       bw // 10 + 2).astype(np.float32))
    base = (F.interpolate(coarse, size=(bh, bw), mode="bilinear",
                          align_corners=False)[0].permute(1, 2, 0).numpy()
            * 255).astype(np.uint8)
    frames = []
    for i in range(n):
        s = zoom ** -i
        vh, vw = int(round(h * s)), int(round(w * s))
        cy = 32 + h / 2 + i * step[0]
        cx = 32 + w / 2 + i * step[1]
        y0, x0 = int(round(cy - vh / 2)), int(round(cx - vw / 2))
        frames.append(resize_bilinear_u8(base[y0:y0 + vh, x0:x0 + vw], h, w))
    return frames


def synth_kitti_train(root: str, rng) -> None:
    """A KITTI training tree: ``image_2/`` 375x1242 frames of a moving
    texture, and for each temporal pair a 16-bit ``flow_occ/`` PNG of a
    smooth known motion with ~30% of the pixels invalid."""
    import numpy as np
    from opticalflow_tpu_torch.io.kitti import write_flow_png
    for d in ("image_2", "flow_occ"):
        os.makedirs(os.path.join(root, d))
    frames = moving_frames(rng, TRAIN_PAIRS + 1, KITTI_H, KITTI_W)
    yy, xx = np.mgrid[0:KITTI_H, 0:KITTI_W].astype(np.float32)
    for i, im in enumerate(frames):
        write_png(os.path.join(root, "image_2", f"{i:06d}_10.png"), im)
        if i < TRAIN_PAIRS:
            flow = np.stack([2.5 + (xx - KITTI_W / 2) * 0.004,
                             1.5 + (yy - KITTI_H / 2) * 0.004], axis=-1)
            write_flow_png(os.path.join(root, "flow_occ", f"{i:06d}_10.png"),
                           flow, rng.rand(KITTI_H, KITTI_W) > 0.3)


def on_cpu(obj):
    """A copy of a state dict (nested dicts and lists of tensors and plain
    values) with every tensor copied to the CPU."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: on_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(on_cpu(v) for v in obj)
    return obj


def state_diff(a, b, path="") -> list:
    """Where two copies of :func:`on_cpu` differ: tensors bit for bit (dtype,
    shape and every bit), everything else by ``==``."""
    import torch
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        same = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and bool((a.view(-1).view(torch.uint8)
                          == b.view(-1).view(torch.uint8)).all()))
        return [] if same else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path} keys"]
        return [d for k in a for d in state_diff(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} length"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in state_diff(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


class Recorder:
    """Wraps ``train.trainer.make_train_step`` while a CLI run lasts: the
    CRC-32 of every batch's ``images`` bytes that reaches the step, in
    order, the host clock as each step starts, and, for each run in the
    block, the state its first step starts from (step, parameters, the
    optimizer's state, on the CPU); and ``checkpoints.save_train_state``:
    what each save wrote, as it was in memory (instrumentation of this
    script; the CLI is unchanged)."""

    def __init__(self, hashes: bool = True, states: bool = False):
        self.hashes = [] if hashes else None
        self.starts = []
        self.states = states
        self.first_states = []
        self.saves = []

    def __enter__(self):
        from opticalflow_tpu_torch.train import checkpoints, trainer
        self._real = real = trainer.make_train_step
        self._real_save = real_save = checkpoints.save_train_state
        rec = self

        def make(model, opt, cfg, mesh=None):
            step = real(model, opt, cfg, mesh)
            first = [True]

            def wrapped(state, batch):
                rec.starts.append(time.perf_counter())
                if rec.states and first[0]:
                    first[0] = False
                    rec.first_states.append({
                        "step": state.step,
                        "params": on_cpu(model.state_dict()),
                        "opt_state": on_cpu(opt.state_dict())})
                if rec.hashes is not None:
                    import zlib
                    rec.hashes.append(zlib.crc32(
                        batch["images"].cpu().numpy().tobytes()))
                return step(state, batch)
            return wrapped

        def save(directory, step, params, opt_state=None, metadata=None,
                 **kw):
            if rec.states:
                rec.saves.append({"directory": directory, "step": step,
                                  "params": on_cpu(params),
                                  "opt_state": on_cpu(opt_state),
                                  "metadata": metadata})
            return real_save(directory, step, params, opt_state, metadata,
                             **kw)

        trainer.make_train_step = make
        checkpoints.save_train_state = save
        return self

    def __exit__(self, *exc):
        from opticalflow_tpu_torch.train import checkpoints, trainer
        trainer.make_train_step = self._real
        checkpoints.save_train_state = self._real_save


def train_cli_run(argv, preempt_after_first: bool = False):
    """One ``cli/train.main`` run in this process.  With
    ``preempt_after_first`` a thread sends this process SIGTERM once the
    first step is logged.  Returns (rc, stdout, wall s)."""
    import contextlib
    import io
    import signal
    import threading
    from opticalflow_tpu_torch.cli import train as train_cli
    out_dir = argv[argv.index("--out-dir") + 1]
    log_path = os.path.join(out_dir, "metrics.jsonl")
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            if os.path.exists(log_path) and os.path.getsize(log_path) > 0:
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.005)

    watcher = threading.Thread(target=watch, daemon=True)
    if preempt_after_first:
        watcher.start()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(argv)
    finally:
        stop.set()
        if preempt_after_first:
            watcher.join(timeout=30)
    wall = time.perf_counter() - t0
    sys.stdout.write(buf.getvalue())
    return rc, buf.getvalue(), wall


def jsonl(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f]


def epoch_rates(text: str):
    """The samples/s the CLI printed for each epoch."""
    return [float(line.split("(")[1].split()[0]) for line in text.splitlines()
            if line.startswith("epoch ") and "samples/s" in line]


def phase_train_cli(sd, tmp, corr_fwd, corr_bwd, card: str):
    """The training CLI on the card: (a) multiscale with preemption and
    resume against uninterrupted runs, (b) the epipolar regime, (c) its
    numbers.  Returns a dict of its results."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.data.datasets import KittiFlowTrain
    from opticalflow_tpu_torch.data.loader import Loader, Subset
    from opticalflow_tpu_torch.train import checkpoints as ckpt
    from opticalflow_tpu_torch.train import trainer as T

    weights = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               weights)
    rng = np.random.RandomState(10)
    kroot = os.path.join(tmp, "kitti_train")
    t0 = time.perf_counter()
    synth_kitti_train(kroot, rng)
    log(f"[10] synthetic KITTI training tree: {TRAIN_PAIRS} pairs of "
        f"{KITTI_H}x{KITTI_W} written in {time.perf_counter() - t0:.1f} s")
    base = ["--regime", "multiscale", "--data-root", kroot,
            "--pretrained", weights, "--crop", str(TRAIN_H), str(TRAIN_W),
            "--batch", str(TRAIN_B), "--epochs", "2", "--workers", "4",
            "--val-frac", "0.25", "--log-every", "1", "--device", "cuda"]

    # (a) six uninterrupted runs (their spread sets the trajectory's
    # tolerance), then a run preempted after its first step and its resume
    corr_fwd.launches = corr_bwd.launches = 0   # the training CLI starts
    runs = {}
    for name in UNINTERRUPTED:
        out = os.path.join(tmp, name)
        # the repeats hash nothing: their rate is the CLI's own
        with Recorder(hashes=name == "uninterrupted") as rec:
            rc, text, wall = train_cli_run(base + ["--out-dir", out])
        assert rc == 0, rc
        runs[name] = {"out": out, "hashes": rec.hashes, "text": text,
                      "wall": wall}
    out = os.path.join(tmp, "preempted")
    with Recorder(states=True) as rec:
        rc, text_p, _ = train_cli_run(base + ["--out-dir", out],
                                      preempt_after_first=True)
        assert rc == 0, rc
        first = [r["step"] for r in jsonl(os.path.join(out, "metrics.jsonl"))
                 if "step" in r]
        # mid-epoch, or on an epoch's last batch after its validation
        assert ("preempted: saved" in text_p
                or "preempted after epoch" in text_p), "no preemption save"
        saved = [sv for sv in rec.saves
                 if os.path.abspath(sv["directory"]) == os.path.abspath(out)]
        rc, text_r, _ = train_cli_run(base + ["--out-dir", out, "--resume"])
        assert rc == 0, rc
    assert "resumed from step" in text_r
    runs["resumed"] = {"out": out, "hashes": rec.hashes}
    # exact resume: the state the resumed run's first step starts from is,
    # bit for bit, the state the preempted run saved last (its parameters,
    # AdamW's moments and step counts, the learning rates, the step); the
    # loader's position and its seeded draws show in the batches' CRC-32
    # below
    assert saved and len(rec.first_states) == 2, (len(saved),
                                                  len(rec.first_states))
    at_save, at_resume = saved[-1], rec.first_states[1]
    assert at_resume["step"] == at_save["step"] == max(first), \
        (at_resume["step"], at_save["step"], first)
    diff = (state_diff(at_save["params"], at_resume["params"], "params")
            + state_diff(at_save["opt_state"], at_resume["opt_state"],
                         "opt_state"))
    n_tensors = (len(at_save["params"])
                 + sum(len(v) for v in at_save["opt_state"]["state"].values()))
    log(f"[10] (a) exact resume: the resumed run starts from step "
        f"{at_resume['step']}; its state against the one the preempted run "
        f"saved, bit for bit ({n_tensors} tensors: parameters, AdamW's "
        f"exp_avg, exp_avg_sq and step; "
        f"{len(at_save['opt_state']['param_groups'])} param groups): "
        f"differing {diff}")
    assert not diff, f"the resumed state differs from the saved one: {diff}"
    steps = {n: [r["step"] for r in jsonl(os.path.join(r_["out"],
                                                        "metrics.jsonl"))
                 if "step" in r] for n, r_ in runs.items()}
    n_steps = 2 * ((TRAIN_PAIRS - TRAIN_PAIRS // 4) // TRAIN_B)
    expect = list(range(1, n_steps + 1))
    log(f"[10] (a) steps logged: uninterrupted {steps['uninterrupted']}, "
        f"preempted at {first} then resumed: {steps['resumed']}")
    for n in runs:
        assert steps[n] == expect, (n, steps[n])
    assert first and max(first) < n_steps, first
    launched_a = (corr_fwd.launches, corr_bwd.launches)  # ... and ends here
    # four runs' worth of steps (5 B1 each), K1 in the steps and in the
    # validation forwards (one batch an epoch, two epochs a run)
    n_runs = len(UNINTERRUPTED) + 1
    assert launched_a[1] == n_runs * 5 * n_steps, launched_a
    assert launched_a[0] == n_runs * 5 * n_steps + n_runs * 2 * 5, launched_a
    assert runs["resumed"]["hashes"] == runs["uninterrupted"]["hashes"], \
        "the resumed run saw other batches"
    losses = {n: np.array([r["loss"] for r in jsonl(os.path.join(
        r_["out"], "metrics.jsonl")) if "step" in r]) for n, r_ in runs.items()}
    params = {n: ckpt.restore_train_state(r_["out"])["params"]
              for n, r_ in runs.items()}

    def param_gap(a, b):
        return max(float((params[a][k] - params[b][k]).abs().max())
                   for k in params[b])

    def loss_gap(a, b):
        return float(np.abs(losses[a] - losses[b]).max())

    # the card is not bit-deterministic (cuDNN's and grid_sample's
    # backwards add with atomics), so the resumed run's trajectory is held,
    # against every uninterrupted run, to 4x the spread of those runs (the
    # largest of their pairs), plus a floor of float32 rounding; the resume
    # itself is held bit for bit above
    pairs = [(a, b) for i, a in enumerate(UNINTERRUPTED)
             for b in UNINTERRUPTED[i + 1:]]
    p_spreads = [param_gap(a, b) for a, b in pairs]
    l_spreads = [loss_gap(a, b) for a, b in pairs]
    p_spread, l_spread = max(p_spreads), max(l_spreads)
    p_top = max(float(v.abs().max()) for v in params["uninterrupted"].values())
    p_tol = 4 * p_spread + 1e-6 * p_top
    l_tol = 4 * l_spread + 1e-6 * float(np.abs(losses["uninterrupted"]).max())
    p_gaps = [param_gap("resumed", u) for u in UNINTERRUPTED]
    l_gaps = [loss_gap("resumed", u) for u in UNINTERRUPTED]
    p_gap, l_gap = max(p_gaps), max(l_gaps)
    log(f"[10] (a) {len(runs['uninterrupted']['hashes'])} batches, the same "
        f"CRC-32 of images in the uninterrupted and resumed runs; final "
        f"parameters: resumed - each uninterrupted run max|d| {p_gaps!r} "
        f"(tolerance {p_tol!r} = 4 x the largest of the uninterrupted runs' "
        f"pairwise {p_spreads!r} + 1e-6 x max|p|); per-step losses: "
        f"{l_gaps!r} (tolerance {l_tol!r}, pairwise {l_spreads!r}); K1/B1 "
        f"launches in the {len(runs)} runs {launched_a}")
    assert p_gap <= p_tol, (p_gap, p_tol)
    assert l_gap <= l_tol, (l_gap, l_tol)
    assert np.isfinite(losses["uninterrupted"]).all()
    rates = epoch_rates(runs["again"]["text"])
    log(f"[10] (c) CLI training, multiscale 4x{TRAIN_H}x{TRAIN_W}, "
        f"--workers 4, loader on the card: {rates} samples/s by epoch (the "
        f"CLI's own print over 3-step epochs: each includes the producer's "
        f"fill, epoch 0 the first step's warm-up); whole run "
        f"{runs['again']['wall']:.2f} s wall with validation and saves; "
        f"{card}")
    # the CLI's steady rate over a longer window: all 16 pairs for 4 epochs
    # (4 steps each), no validation; the clock at each step's start gives
    # the batches' delivery intervals inside epochs 1-3 (no warm-up, no
    # producer fill)
    steady_argv = [a for a in base if a not in ("--val-frac", "0.25")]
    steady_argv[steady_argv.index("--epochs") + 1] = str(STEADY_EPOCHS)
    with Recorder(hashes=False) as rec:
        rc, text_s, wall_s = train_cli_run(
            steady_argv + ["--out-dir", os.path.join(tmp, "steady"),
                           "--save-every", "100"])
    assert rc == 0, rc
    per = TRAIN_PAIRS // TRAIN_B
    assert len(rec.starts) == STEADY_EPOCHS * per, len(rec.starts)
    gaps = [b - a for e in range(1, STEADY_EPOCHS)
            for a, b in zip(rec.starts[e * per:(e + 1) * per],
                            rec.starts[e * per + 1:(e + 1) * per])]
    steady_rate = len(gaps) * TRAIN_B / sum(gaps)
    fills = [rec.starts[e * per] - rec.starts[e * per - 1]
             for e in range(1, STEADY_EPOCHS)]
    log(f"[10] (c) CLI steady state, {STEADY_EPOCHS} epochs of {per} steps, "
        f"no validation: {steady_rate!r} samples/s over {len(gaps)} batch "
        f"intervals inside epochs 1-{STEADY_EPOCHS - 1} "
        f"({sum(gaps):.3f} s); step-to-step across an epoch boundary "
        f"(save, new producer, fill) {[round(f, 3) for f in fills]} s; "
        f"CLI prints {epoch_rates(text_s)} samples/s by epoch; whole run "
        f"{wall_s:.2f} s wall; {card}")

    # (b) the epipolar regime on frames moved by a known camera motion
    froot = os.path.join(tmp, "frames")
    os.makedirs(froot)
    for i, im in enumerate(moving_frames(rng, EPI_FRAMES, KITTI_H, KITTI_W)):
        write_png(os.path.join(froot, f"frame_{i:04d}.png"), im)
    from opticalflow_tpu_torch.cli import train as train_cli
    real_attach = train_cli._attach_epipolar
    coverage = []

    def attach(model, step, batch, args):
        out = real_attach(model, step, batch, args)
        coverage.extend(float(m) for m in out["photo_mask"].mean((1, 2)))
        return out

    epi_out = os.path.join(tmp, "epipolar")
    train_cli._attach_epipolar = attach
    corr_fwd.launches = corr_bwd.launches = 0   # the epipolar path starts
    try:
        rc, text_e, wall_e = train_cli_run([
            "--regime", "epipolar", "--data-root", froot, "--pretrained",
            weights, "--batch", str(TRAIN_B), "--epochs", "1", "--workers",
            "4", "--log-every", "1", "--epi-soft-w", "0.1", "--device",
            "cuda", "--out-dir", epi_out])
    finally:
        train_cli._attach_epipolar = real_attach
    launched = (corr_fwd.launches, corr_bwd.launches)  # ... and ends here
    assert rc == 0, rc
    recs = [r for r in jsonl(os.path.join(epi_out, "metrics.jsonl"))
            if "step" in r]
    n_epi = (EPI_FRAMES - 1) // TRAIN_B
    log(f"[10] (b) epipolar regime, {n_epi} steps at 4x384x512: losses "
        f"{[r['loss'] for r in recs]}, sampson {[r['sampson'] for r in recs]}"
        f"; mask coverage per sample {[round(c, 4) for c in coverage]}; K1/B1"
        f" launches {launched} (10 and 5 a step); {wall_e:.2f} s wall; {card}")
    assert [r["step"] for r in recs] == list(range(1, n_epi + 1))
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["sampson"])
               for r in recs), recs
    assert coverage and all(0.0 < c < 1.0 for c in coverage), coverage
    assert launched == (10 * n_epi, 5 * n_epi), launched

    # (c) the loader alone (decode, reduced_affine, crop; 4 threads, no
    # card) and the step alone on a batch already on the card
    ds = KittiFlowTrain(kroot, crop_hw=(TRAIN_H, TRAIN_W), seed=0)
    t0 = time.perf_counter()
    for i in range(4):
        ds.get(i, epoch=0)
    one_ms = (time.perf_counter() - t0) / 4 * 1e3
    # one sample's pieces on one thread: decode (two frames and the
    # 16-bit GT) and reduced_affine when it warps (60% of the samples)
    from opticalflow_tpu_torch.data.augment import reduced_affine
    from opticalflow_tpu_torch.io.images import load_image
    from opticalflow_tpu_torch.io.kitti import read_flow_png
    t0 = time.perf_counter()
    for p1, p2, pf in ds.samples[:4]:
        im1, im2 = (load_image(p).astype(np.float32) / 255.0
                    for p in (p1, p2))
        flow, valid = read_flow_png(pf)
    decode_ms = (time.perf_counter() - t0) / 4 * 1e3
    warping = [s_ for s_ in range(50)
               if np.random.default_rng(s_).random() >= 0.4][:4]
    t0 = time.perf_counter()
    for s_ in warping:
        reduced_affine(im1, im2, flow, valid, np.random.default_rng(s_))
    affine_ms = (time.perf_counter() - t0) / len(warping) * 1e3
    lo = Loader(ds, TRAIN_B, num_workers=4, seed=0)
    t0 = time.perf_counter()
    n = sum(b["images"].shape[0] for _ in range(2) for b in lo)
    wall = time.perf_counter() - t0
    loader_rate = n / wall
    log(f"[10] (c) loader alone, --workers 4: {loader_rate!r} samples/s "
        f"({wall / n * 1e3!r} ms a sample, {n} samples); one thread: "
        f"{one_ms!r} ms a sample, of which decode {decode_ms!r} ms and, "
        f"on the 60% of samples it warps, reduced_affine {affine_ms!r} ms; "
        f"{card}")

    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.models.torch_import import reference_state_dict
    model = PWCDCNet(precision="fast").cuda()
    cfg = T.TrainConfig(loss="multiscale", optimizer="adamw")
    state, opt = T.create_train_state(model, cfg,
                                      params=reference_state_dict(sd))
    step = T.make_train_step(model, opt, cfg)
    # one batch through the loader, its producer finished: a decode still
    # running beside the step would hold the GIL the step's host work needs
    batch, = list(Loader(Subset(ds, range(TRAIN_B)), TRAIN_B, num_workers=4,
                         seed=0, device="cuda"))
    ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(ms[1:]))
    log(f"[10] (c) the step alone on a batch on the card: "
        f"{[round(x, 2) for x in ms]} ms (median after the first "
        f"{step_ms!r} ms, {TRAIN_B / step_ms * 1e3!r} samples/s); {card}")
    return {"steps": steps["resumed"], "preempted_at": max(first),
            "batches": len(runs["uninterrupted"]["hashes"]),
            "param_gap": p_gap, "param_tol": p_tol, "param_spread": p_spread,
            "param_spreads": p_spreads, "loss_spreads": l_spreads,
            "loss_gap": l_gap, "loss_tol": l_tol, "loss_spread": l_spread,
            "exact_resume_tensors": n_tensors,
            "cli_samples_per_s": rates,
            "cli_steady_samples_per_s": steady_rate,
            "cli_steady_intervals_s": gaps,
            "cli_wall_s": runs["again"]["wall"],
            "epipolar": {"losses": [r["loss"] for r in recs],
                         "sampson": [r["sampson"] for r in recs],
                         "mask_coverage": coverage, "wall_s": wall_e},
            "launches": {"correlation_fwd": launched_a[0] + launched[0],
                         "correlation_bwd": launched_a[1] + launched[1]},
            "launches_epipolar": {"correlation_fwd": launched[0],
                                  "correlation_bwd": launched[1]},
            "loader_samples_per_s": loader_rate,
            "loader_ms_per_sample": wall / n * 1e3,
            "sample_ms_one_thread": one_ms, "decode_ms": decode_ms,
            "reduced_affine_ms": affine_ms,
            "step_ms": ms, "step_ms_median": step_ms, "card": card}



# ------------------------------------------------------------ phase 11

# the video path: a 720p clip at B=4 in each overlay mode, one 1080p pass
# (the levels of K2's domain), bfloat16 (extract_video's default).  Each run
# is timed whole, from its first frame read to its writer's release, over
# enough pairs that the pipeline's fill (decoding and issuing the first
# depth + 1 windows before the first result) is a small share of it.
VIDEO_H, VIDEO_W, VIDEO_FRAMES = 720, 1280, 240
HD_H, HD_W, HD_FRAMES = 1080, 1920, 64
VIDEO_B = 4
FIXED_SIZE = (384, 1280)        # resize_fixed's image size, the v1 default
# (mode, flags, frames read): the modes whose draw is slow read fewer
# frames, so that each run lasts 5-8 s
VIDEO_RUNS = (("arrows", (), 240), ("arrows", ("--upload", "i420"), 160),
              ("color", (), 80), ("vanish", ("--shrink", "0.75"), 160),
              ("topview", (), 40))
# the correlation inputs of the video path: the levels of a 720p frame
# padded to 768x1280 (and LEVELS_1080 at 1080p), at B=VIDEO_B
LEVELS_768 = (("L2", 192, 320, 32), ("L3", 96, 160, 64), ("L4", 48, 80, 96),
              ("L5", 24, 40, 128), ("L6", 12, 20, 196))


def write_clip(path: str, frames) -> float:
    """``frames`` as a .y4m by the port's writer; host ms a frame."""
    from opticalflow_tpu_torch.io.video import Y4MWriter
    h, w = frames[0].shape[:2]
    t0 = time.perf_counter()
    wr = Y4MWriter(path, 30.0, (w, h))
    for f in frames:
        wr.write(f)
    wr.release()
    return (time.perf_counter() - t0) / len(frames) * 1e3


class PipelineRecorder:
    """Instruments the ``cli/extract_video`` runs made while the context
    lasts (this script's instrumentation; the CLI is unchanged): keeps the
    ``VideoFlowRunner`` each builds, the host's busy seconds by stage (the
    decode thread inside ``io/video.read_frames``, the main thread's
    top-view warps and draws, the encode thread's ``.y4m`` or ``.mp4``
    writes) and the
    times of the first frame read, the first draw and the writer's
    release."""

    def __enter__(self):
        from opticalflow_tpu_torch import video
        from opticalflow_tpu_torch.cli import extract_video
        from opticalflow_tpu_torch.io import video as vio
        from opticalflow_tpu_torch.viz import topview
        self.runners = runners = []
        self.busy = busy = {"decode": 0.0, "warp": 0.0, "draw": 0.0,
                            "encode": 0.0}
        self.marks = marks = {}
        self._saved = []

        def timed(stage, real, mark=None):
            def call(*a, **k):
                t0 = time.perf_counter()
                if mark:
                    marks.setdefault(mark, t0)
                try:
                    return real(*a, **k)
                finally:
                    busy[stage] += time.perf_counter() - t0
            return call

        def reads(real):
            def gen(*a, **k):
                it = real(*a, **k)
                step = timed("decode", lambda: next(it, None), "first_read")
                while (frame := step()) is not None:
                    yield frame
            return gen

        def released(real):
            def call(*a, **k):
                real(*a, **k)
                marks["released"] = time.perf_counter()
            return call

        def recorded(real):
            class Recorded(real):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    runners.append(self)
            return Recorded

        for owner, name, make in (
                (video, "VideoFlowRunner", recorded),
                (video, "read_frames", reads),
                (topview, "warp_topview", lambda r: timed("warp", r)),
                (extract_video.Overlay, "__call__",
                 lambda r: timed("draw", r, "first_draw")),
                (vio.Y4MWriter, "write", lambda r: timed("encode", r)),
                (vio.Mpeg4Writer, "write", lambda r: timed("encode", r)),
                (vio.AsyncVideoWriter, "release", released)):
            real = getattr(owner, name)
            self._saved.append((owner, name, real))
            setattr(owner, name, make(real))
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self._saved):
            setattr(owner, name, real)


class FlowRecorder:
    """Keeps every flow ``FlowEngine.flow_from_pairs`` returns while the
    context lasts (instrumentation of this script)."""

    def __enter__(self):
        from opticalflow_tpu_torch.engine import FlowEngine
        self._real = real = FlowEngine.flow_from_pairs
        self.flows = flows = []

        def recorded(engine, *a, **k):
            out = real(engine, *a, **k)
            flows.append(out)
            return out

        FlowEngine.flow_from_pairs = recorded
        return self

    def __exit__(self, *exc):
        from opticalflow_tpu_torch.engine import FlowEngine
        FlowEngine.flow_from_pairs = self._real


def video_cli(argv, n_frames: int, h: int, w: int):
    """``cli/extract_video.main(argv)`` in this process, instrumented, on
    ``n_frames`` frames of (h, w); checks its output (the frame count and
    size from the file's index, its first, middle and last frames decoded)
    and returns its timings: the whole run's fps, the fill, each stage's
    host ms a frame and its share of the run, and the fps the CLI printed
    (timed from its first result, as the JAX CLI's)."""
    import contextlib
    import io
    from opticalflow_tpu_torch.cli import extract_video
    from opticalflow_tpu_torch.io.video import read_frame, video_info
    buf = io.StringIO()
    with PipelineRecorder() as rec, contextlib.redirect_stdout(buf):
        rc = extract_video.main(argv)
    text = buf.getvalue()
    sys.stdout.write(text)
    assert rc == 0 and len(rec.runners) == 1, (rc, len(rec.runners))
    printed = [float(line.split("(")[1].split()[0])
               for line in text.splitlines() if "fps steady-state" in line]
    info = video_info(argv[1])
    ow = 2 * w if "color" in argv or "compare" in argv else w
    assert info["frames"] == n_frames - 1, (info, n_frames)
    assert (info["height"], info["width"]) == (h, ow), info
    for i in (0, info["frames"] // 2, info["frames"] - 1):
        assert read_frame(argv[1], i).shape == (h, ow, 3)
    runner, marks, busy = rec.runners[0], rec.marks, rec.busy
    pairs = n_frames - 1
    run_s = marks["released"] - marks["first_read"]
    st = runner.stats
    row = {"frames": n_frames, "fps": pairs / run_s, "run_s": run_s,
           "fill_s": marks["first_draw"] - marks["first_read"],
           "cli_printed_fps": printed[-1], "runner": runner,
           "windows": st["windows"], "bytes_uploaded": st["bytes_uploaded"]}
    # host ms a frame (decode, warp: every frame read; the rest a pair)
    # and the share of the run each thread was busy in that stage
    for stage, sec, n in (("decode", busy["decode"], n_frames),
                          ("warp", busy["warp"], n_frames),
                          ("upload", st["upload_s"], pairs),
                          ("issue", st["issue_s"], pairs),
                          ("wait", st["wait_s"], pairs),
                          ("draw", busy["draw"], pairs),
                          ("encode", busy["encode"], pairs)):
        row[f"{stage}_ms"] = sec / n * 1e3
        row[f"{stage}_share"] = sec / run_s
    return row


def phase_video_checks(sd):
    """The video path's device ops against their plain versions on the
    card, before its counted run: K1/K2 at the shapes the path gives them,
    the I420 unpack, the grid decimation, and in float32 parity mode the
    i420 runner against the bgr runner fed I420-round-tripped frames."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.io.yuv import i420_to_rgb, rgb_to_i420
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.scripts._timing import cuda_ms
    from opticalflow_tpu_torch.video import (VideoFlowRunner, decimate_flow,
                                             yuv_i420_to_rgb_u8)

    worst = corr_check([(VIDEO_B, s) for s in LEVELS_768 + LEVELS_1080],
                       torch.Generator(device="cuda").manual_seed(11),
                       "[11] K1 at the video path's levels")
    log(f"[11] K1 against the plain correlation at every level of 768x1280 "
        f"and 1088x1920, B={VIDEO_B}: max abs float32 "
        f"{worst[torch.float32]!r}, bfloat16 {worst[torch.bfloat16]!r} "
        f"(phase 2's tolerances)")

    rng = np.random.RandomState(12)
    frames = moving_frames(rng, 6, VIDEO_H, VIDEO_W)
    packed = np.stack([rgb_to_i420(f) for f in frames])
    dev = torch.from_numpy(packed).cuda()
    got = yuv_i420_to_rgb_u8(dev).cpu().numpy()
    for g, p in zip(got, packed):
        assert np.array_equal(g, i420_to_rgb(p)), "I420 unpack off io/yuv"
    ms = cuda_ms(lambda _: yuv_i420_to_rgb_u8(dev), 20)
    log(f"[11] yuv_i420_to_rgb_u8 on the card, 6 frames 720x1280: "
        f"bit-exact to io/yuv's numpy; {ms:.3f} ms by CUDA events")

    q = torch.from_numpy(rng.randn(VIDEO_B, 192, 320, 2).astype(np.float32)
                         * 6)
    host = decimate_flow(q, 16, VIDEO_H, VIDEO_W)
    card = decimate_flow(q.cuda(), 16, VIDEO_H, VIDEO_W).cpu()
    d_err = float((card - host).abs().max())
    log(f"[11] decimate_flow on the card vs the host: max abs {d_err!r} "
        f"(bound 1e-4)")
    assert d_err <= 1e-4, d_err

    def roundtrip(f):
        return np.ascontiguousarray(i420_to_rgb(rgb_to_i420(
            np.ascontiguousarray(f[..., ::-1])))[..., ::-1])

    kw = dict(batch=VIDEO_B, device="cuda")
    a = [f for _, _, f in VideoFlowRunner(PWCDCNet(), sd, upload="i420",
                                          **kw).run(iter(frames))]
    b = [f for _, _, f in VideoFlowRunner(PWCDCNet(), sd, upload="bgr",
                                          **kw).run(roundtrip(f)
                                                    for f in frames)]
    r_err = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    log(f"[11] float32 parity: the i420 runner against the bgr runner on "
        f"I420-round-tripped frames, 5 pairs of 720x1280: max abs "
        f"{r_err!r} (bound 1e-4)")
    assert len(a) == len(b) == 5 and r_err <= 1e-4, (len(a), r_err)
    return {"k1_err_f32": worst[torch.float32],
            "k1_err_bf16": worst[torch.bfloat16],
            "k1_shapes": [[VIDEO_B, *s[1:]] for s in LEVELS_768 + LEVELS_1080],
            "i420_ms": ms, "decimate_err": d_err, "runner_i420_err": r_err}


def log_video_row(what: str, row, card: str) -> None:
    log(f"[11] extract_video {what} B={VIDEO_B} bf16, {row['frames']} "
        f"frames: {row['fps']!r} fps over the whole run ({row['run_s']!r} s "
        f"from the first frame read to the writer's release; the fill to "
        f"the first result {row['fill_s']!r} s; the CLI printed "
        f"{row['cli_printed_fps']} fps, timed from its first result); "
        f"{row['windows']} windows, K1 {row['k1_launches']} launches; host "
        f"ms a frame and share of the run busy: decode thread "
        f"{row['decode_ms']:.2f} ({row['decode_share']:.0%}), warp "
        f"{row['warp_ms']:.2f} ({row['warp_share']:.0%}), upload "
        f"{row['upload_ms']:.2f} ({row['upload_share']:.0%}), issue "
        f"{row['issue_ms']:.2f} ({row['issue_share']:.0%}), readback wait "
        f"{row['wait_ms']:.2f} ({row['wait_share']:.0%}), draw "
        f"{row['draw_ms']:.2f} ({row['draw_share']:.0%}), encode thread "
        f"{row['encode_ms']:.2f} ({row['encode_share']:.0%}) [{card}]")


def phase_video(sd, tmp, corr_fwd, card: str):
    """The video CLIs on the card: every overlay mode on a 720p clip, one
    1080p pass, their outputs checked; K1 launches and upload bytes per
    window; each run's fps over the whole run and host ms a frame by
    stage.  Returns its results."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.io.video import read_frames

    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    rng = np.random.RandomState(11)
    clip = os.path.join(tmp, "clip720.y4m")
    encode_ms = write_clip(clip, moving_frames(rng, VIDEO_FRAMES, VIDEO_H,
                                               VIDEO_W))
    t0 = time.perf_counter()
    n_alone = len(list(read_frames(clip, max_frames=20)))
    decode_ms = (time.perf_counter() - t0) / n_alone * 1e3
    log(f"[11] clip: {VIDEO_FRAMES} frames {VIDEO_H}x{VIDEO_W} .y4m; host "
        f"alone, one thread: encode {encode_ms:.2f} ms a frame (RGB->I420, "
        f"write), decode {decode_ms:.2f} ms a frame (read, I420->RGB; "
        f"{n_alone} frames) [{card}]")
    h64, w64 = -(-VIDEO_H // 64) * 64, -(-VIDEO_W // 64) * 64
    results = {"encode_ms": encode_ms, "decode_ms": decode_ms, "modes": {}}
    for mode, extra, n in VIDEO_RUNS:
        name = mode + ("_i420" if "i420" in extra else "")
        before = corr_fwd.launches
        row = video_cli([clip, os.path.join(tmp, f"out_{name}.y4m"), "--ckpt",
                         ckpt, "--mode", mode, "--batch", str(VIDEO_B),
                         "--device", "cuda", "--max-frames", str(n), *extra],
                        n, VIDEO_H, VIDEO_W)
        row["k1_launches"] = launched = corr_fwd.launches - before
        windows = row["windows"]
        assert windows == -(-(n - 1) // VIDEO_B), windows
        assert launched == 5 * windows, (launched, windows)
        row["bytes_per_window"] = per_window = \
            row.pop("bytes_uploaded") / windows
        want = (VIDEO_B + 1) * (VIDEO_H * VIDEO_W * 3 // 2 if "i420" in extra
                                else h64 * w64 * 3)
        assert per_window == want, (per_window, want)
        del row["runner"]
        results["modes"][name] = row
        log_video_row(f"--mode {mode} {' '.join(extra)} {VIDEO_H}x{VIDEO_W}"
                      f" ({per_window:.0f} bytes uploaded a window)", row,
                      card)

    # 1080p: the correlation levels of K2's domain
    hd = os.path.join(tmp, "clip1080.y4m")
    write_clip(hd, moving_frames(rng, HD_FRAMES, HD_H, HD_W))
    before = corr_fwd.launches
    row = video_cli([hd, os.path.join(tmp, "out1080.y4m"), "--ckpt", ckpt,
                     "--mode", "arrows", "--batch", str(VIDEO_B), "--device",
                     "cuda"], HD_FRAMES, HD_H, HD_W)
    row["k1_launches"] = launched = corr_fwd.launches - before
    windows = row["windows"]
    assert launched == 5 * windows == 5 * -(-(HD_FRAMES - 1) // VIDEO_B), \
        (launched, windows)
    del row["runner"], row["bytes_uploaded"]
    results["modes"]["arrows_1080"] = row
    log_video_row(f"--mode arrows {HD_H}x{HD_W}", row, card)
    assert "cv2" not in sys.modules, "the port imported OpenCV"
    return results


def phase_video_forward(sd, card: str):
    """The video CLIs' forward alone (bf16 fast, B=4) by CUDA events."""
    import torch
    from opticalflow_tpu_torch.cli.extract_flow import build_model
    from opticalflow_tpu_torch.models.torch_import import reference_state_dict
    from opticalflow_tpu_torch.scripts._timing import cuda_ms
    model = build_model("new", "bfloat16")
    model.load_state_dict(reference_state_dict(sd))
    model = model.cuda().eval()
    out = {}
    for h, w in ((768, 1280), (1088, 1920)):
        x = torch.rand(VIDEO_B, 6, h, w, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(2))
        with torch.inference_mode():
            out[f"{h}x{w}"] = ms = cuda_ms(lambda _: model(x), 10)
        log(f"[11] forward alone {h}x{w} B={VIDEO_B} bf16 fast: {ms:.3f} ms "
            f"({ms / VIDEO_B:.3f} ms a pair) [{card}]")
    return out


def phase_video_engine(sd, tmp):
    """The engine's leftovers on the card: ``resize_fixed`` on the golden
    pair through the engine and through ``cli/infer_kitti`` against the
    port on the CPU, and ``flow_from_batch`` against the pad path."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.cli import infer_kitti
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.io.images import (load_image,
                                                 pad_to_multiple_of_64,
                                                 preprocess_pair)
    from opticalflow_tpu_torch.io.kitti import write_flow_png
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet

    im1, im2 = (load_image(os.path.join(GOLD, f"real_im{i}.png"))
                for i in (1, 2))
    kw = dict(preset="rgb_imagenet", size_mode="resize_fixed",
              image_size=FIXED_SIZE)
    cpu = FlowEngine(PWCDCNet(), sd, flow_scale=1.0, device="cpu")
    ref = cpu.flow_from_pair(im1, im2, **kw)
    engine = FlowEngine(PWCDCNet(), sd, flow_scale=1.0, device="cuda")
    d_engine = epe(engine.flow_from_pair(im1, im2, **kw), ref)

    kroot = os.path.join(tmp, "kitti_fixed", "training")
    for d in ("image_2", "flow_occ"):
        os.makedirs(os.path.join(kroot, d))
    write_png(os.path.join(kroot, "image_2", "000000_10.png"), im1)
    write_png(os.path.join(kroot, "image_2", "000000_11.png"), im2)
    write_flow_png(os.path.join(kroot, "flow_occ", "000000_10.png"), ref,
                   np.ones(ref.shape[:2], bool))
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    with FlowRecorder() as rec:
        rc, printed, _ = run_cli(infer_kitti.main, [
            "--root", os.path.dirname(kroot), "--ckpt", ckpt, "--size-mode",
            "resize_fixed", "--image-size", *map(str, FIXED_SIZE), "--batch",
            "1", "--device", "cuda"])
    assert rc == 0 and len(rec.flows) == 1, (rc, len(rec.flows))
    d_cli = epe(rec.flows[0][0], ref)
    log(f"[11] resize_fixed ({FIXED_SIZE[0]}x{FIXED_SIZE[1]}) on the golden pair, "
        f"card against the port on the CPU: engine mean EPE {d_engine:.3e}, "
        f"cli/infer_kitti {d_cli:.3e} (bound 1e-4); its printed EPE against "
        f"that flow as a 16-bit PNG {printed} (the PNG's 1/64 px)")
    assert d_engine <= 1e-4 and d_cli <= 1e-4 and printed <= 0.02

    x, _, _ = pad_to_multiple_of_64(preprocess_pair(im1, im2,
                                                    preset="rgb_imagenet"))
    got = engine.flow_from_batch(x, align_corners=True)[0, :180, :318]
    pad = engine.flow_from_pair(im1, im2, preset="rgb_imagenet",
                                size_mode="pad")
    d_batch = float(np.abs(got.cpu().numpy() - pad).max())
    log(f"[11] flow_from_batch (align_corners) against the pad path on the "
        f"same input: max abs {d_batch!r} (bound 1e-4)")
    assert d_batch <= 1e-4
    return {"resize_fixed_epe": d_engine, "infer_kitti_epe": d_cli,
            "flow_from_batch_err": d_batch}


# ------------------------------------------------------------ phase 12

# serving at Sintel size: 16 moving pairs; 16 client threads send 128 raw
# requests, then one client 16 in a row (the B=1 bucket), then 4 JSON ones;
# a burst of 16 is drained by SIGTERM
SERVE_PAIRS = 16
SERVE_CLIENTS = 16
SERVE_CONCURRENT = 128
SERVE_JSON = 4
# the serving CLI, run in a child process by this script with its own
# instrumentation (the CLI is unchanged): K1's count set to 0 before main
# and read after it returns; the FlowServer's final metrics; every engine
# call of the dispatch thread (start, end, batch, host /64 resize seconds
# inside it); the card's peak memory.  One JSON line after main returns.
SERVE_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from opticalflow_tpu_torch import serve as S
from opticalflow_tpu_torch.cli import serve as cli
from opticalflow_tpu_torch.engine import FlowEngine
from opticalflow_tpu_torch.io import images as imio
from opticalflow_tpu_torch.ops.corr_cuda import correlation_cuda

servers, calls, resize_s = [], [], [0.0]


class Server(S.FlowServer):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        servers.append(self)


def timed_pairs(self, im1s, im2s, _real=FlowEngine.flow_from_pairs, **kw):
    r0, t0 = resize_s[0], time.perf_counter()
    out = _real(self, im1s, im2s, **kw)
    calls.append((t0, time.perf_counter(), len(im1s), resize_s[0] - r0))
    return out


def timed_resize(img, _real=imio.resize_to_multiple_of_64):
    t0 = time.perf_counter()
    out = _real(img)
    resize_s[0] += time.perf_counter() - t0
    return out


S.FlowServer = Server
FlowEngine.flow_from_pairs = timed_pairs
imio.resize_to_multiple_of_64 = timed_resize
correlation_cuda.launches = 0
rc = cli.main(sys.argv[2:])
print("SERVE_CHILD " + json.dumps({
    "rc": rc, "launches": correlation_cuda.launches,
    "metrics": servers[0].metrics.snapshot(),
    "buckets": servers[0].bucket_sizes, "calls": calls,
    "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}), flush=True)
sys.exit(rc)
"""


def post(conn, body, headers):
    """One POST /v1/flow on a kept-alive connection: (status, body bytes,
    seconds from the request's first byte to the response's last)."""
    t0 = time.perf_counter()
    conn.request("POST", "/v1/flow", body, headers)
    resp = conn.getresponse()
    data = resp.read()
    return resp.status, data, time.perf_counter() - t0


def get_json(port: int, path: str):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        assert resp.status == 200, (path, resp.status)
        return json.loads(resp.read())
    finally:
        conn.close()


def flo_array(data: bytes, h: int, w: int):
    import struct
    import numpy as np
    tag, fw, fh = struct.unpack("<fii", data[:12])
    assert abs(tag - 202021.25) < 1e-3 and (fh, fw) == (h, w), (tag, fh, fw)
    return np.frombuffer(data[12:], "<f4").reshape(h, w, 2)


def percentiles(seconds) -> dict:
    """p50/p90/p99 in ms, by the same rule as ``ServerMetrics.snapshot``."""
    s = sorted(seconds)
    return {f"p{int(q * 100)}": s[min(len(s) - 1, int(q * len(s)))] * 1e3
            for q in (0.50, 0.90, 0.99)}


def burst(port: int, jobs, headers, clients: int):
    """``jobs`` (pair index, body) sent by ``clients`` threads, each on its
    own kept-alive connection, every thread's share in order.  Returns
    [(pair index, status, body, seconds)] and the burst's wall seconds."""
    import http.client
    import threading
    results = []
    lock = threading.Lock()

    def client(share):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            for i, body in share:
                r = post(conn, body, headers)
                with lock:
                    results.append((i, *r))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(jobs[k::clients],))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads), "a client hung"
    return results, wall


def start_serving_cli(argv):
    """The serving CLI in a child process (:data:`SERVE_CHILD`); returns
    (process, its port, its output lines: a list the reader thread keeps
    appending to until the child exits, the reader thread)."""
    import queue
    import subprocess
    import threading
    proc = subprocess.Popen([sys.executable, "-c", SERVE_CHILD, ROOT, *argv],
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, ports = [], queue.Queue()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on http://"):
                ports.put(int(line.split("http://")[1].split()[0]
                              .rsplit(":", 1)[1]))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    deadline = time.perf_counter() + 300
    while True:
        try:
            return proc, ports.get(timeout=1.0), lines, reader
        except queue.Empty:
            if proc.poll() is not None or time.perf_counter() > deadline:
                proc.kill()
                raise AssertionError("the serving CLI did not come up:\n"
                                     + "".join(lines[-40:]))


def dispatch_share(calls, t0: float, t1: float) -> dict:
    """The dispatch thread's engine calls inside [t0, t1] (its clock and this
    process's are both CLOCK_MONOTONIC): busy share of the window, the host
    /64 resize's share, mean batch, ms a call."""
    inside = [c for c in calls if c[0] >= t0 and c[1] <= t1]
    busy = sum(c[1] - c[0] for c in inside)
    return {"calls": len(inside), "busy_share": busy / (t1 - t0),
            "resize_share": sum(c[3] for c in inside) / (t1 - t0),
            "mean_batch": (sum(c[2] for c in inside) / len(inside)
                           if inside else 0.0),
            "ms_per_call": busy / len(inside) * 1e3 if inside else 0.0}


def phase_serve(sd, tmp, counter, card: str):
    """The serving CLI on the card at its defaults, then a float32
    parity-mode server in this process and the engine alone.  Returns a
    dict of its results."""
    import base64
    import http.client
    import signal
    import threading
    import numpy as np
    import torch
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.io.images import encode_png
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.serve import FlowServer, make_http_server

    t_phase = time.perf_counter()
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    frames = moving_frames(np.random.RandomState(12), SERVE_PAIRS + 1,
                           FULL_H, FULL_W)
    pairs = list(zip(frames[:-1], frames[1:]))
    bodies = [a.tobytes() + b.tobytes() for a, b in pairs]
    raw = {"Content-Type": "application/octet-stream",
           "X-Frame-Shape": f"{FULL_H}x{FULL_W}x3", "X-Timeout": "120"}

    # 1. the CLI at its defaults (bfloat16 fast, max batch 8, 5 ms, auto
    # buckets), warmed up at Sintel size
    t0 = time.perf_counter()
    proc, port, lines, reader = start_serving_cli(
        ["--ckpt", ckpt, "--port", "0", "--warmup", f"{FULL_H}x{FULL_W}",
         "--device", "cuda"])
    startup_s = time.perf_counter() - t0
    try:
        # 2. concurrent traffic, then one client in a row, then JSON
        jobs = [(i % SERVE_PAIRS, bodies[i % SERVE_PAIRS])
                for i in range(SERVE_CONCURRENT)]
        t_c0 = time.perf_counter()
        conc, wall_c = burst(port, jobs, raw, SERVE_CLIENTS)
        t_c1 = time.perf_counter()
        m_c = get_json(port, "/metrics")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        t_s0 = time.perf_counter()
        seq = [post(conn, body, raw) for body in bodies]
        t_s1 = time.perf_counter()
        m_s = get_json(port, "/metrics")
        json_resp = []
        for i in range(SERVE_JSON):
            req = json.dumps({k: base64.b64encode(encode_png(im)).decode()
                              for k, im in zip(("im1", "im2"), pairs[i])})
            json_resp.append(post(conn, req.encode(),
                                  {"Content-Type": "application/json"}))
        conn.close()
        # 3. the probes
        health = get_json(port, "/healthz")
        m_all = get_json(port, "/metrics")
        # 6. a burst of 16 on fresh connections, SIGTERM once the first
        # answer is back (all 16 were accepted long before: a batch takes
        # far longer than 16 connects)
        drained, first = [], threading.Event()

        def one(i):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            try:
                drained.append((i, *post(c, bodies[i], raw)))
            finally:
                c.close()
                first.set()

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(SERVE_PAIRS)]
        for t in threads:
            t.start()
        assert first.wait(120), "no answer in the SIGTERM burst"
        proc.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(timeout=300)
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    reader.join(timeout=60)                 # the child's last lines
    child = [json.loads(ln.split(" ", 1)[1]) for ln in lines
             if ln.startswith("SERVE_CHILD ")]
    assert rc == 0 and child, (rc, "".join(lines[-40:]))
    child = child[0]
    for (i, status, data, _) in conc + drained:
        assert status == 200, (i, status, data[:200])
        f = flo_array(data, FULL_H, FULL_W)
        assert np.isfinite(f).all(), i
    assert all(status == 200 for status, _, _ in seq + json_resp)
    assert len(drained) == SERVE_PAIRS, len(drained)
    # the JSON route decodes the same frames: the same bytes as the raw
    # requests of the same pairs, which rode the same B=1 bucket
    for i, (_, data, _) in enumerate(json_resp):
        assert data == seq[i][1], f"JSON pair {i} differs from the raw one"
    n_total = SERVE_CONCURRENT + 2 * SERVE_PAIRS + SERVE_JSON
    assert health == {"ok": True}, health
    assert m_c["requests"] == SERVE_CONCURRENT and m_c["errors"] == 0, m_c
    assert m_s["batches"] - m_c["batches"] == SERVE_PAIRS, (m_s, m_c)
    assert m_all["requests"] == n_total - SERVE_PAIRS, m_all
    final = child["metrics"]
    assert final["requests"] == n_total and final["errors"] == 0, final
    # 5. K1: 5 launches a dispatched batch, and a warm-up forward per
    # bucket and size mode
    warm = len(child["buckets"]) * 2
    assert child["launches"] == 5 * (final["batches"] + warm), \
        (child["launches"], final["batches"], warm)
    occupancy_c = SERVE_CONCURRENT / m_c["batches"]
    lat_c = percentiles([r[3] for r in conc])
    lat_s = percentiles([r[2] for r in seq])
    share = dispatch_share(child["calls"], t_c0, t_c1)
    share_s = dispatch_share(child["calls"], t_s0, t_s1)
    rps = SERVE_CONCURRENT / wall_c
    log(f"[12] serving CLI (bfloat16 fast, --max-batch 8, --max-delay-ms 5, "
        f"buckets {child['buckets']}), {FULL_H}x{FULL_W} raw requests: "
        f"startup with warm-up {startup_s:.1f} s; {SERVE_CONCURRENT} from "
        f"{SERVE_CLIENTS} clients in {wall_c:.3f} s = {rps!r} requests/s, "
        f"latency p50/p90/p99 {lat_c['p50']:.1f} / {lat_c['p90']:.1f} / "
        f"{lat_c['p99']:.1f} ms, {m_c['batches']} batches, mean occupancy "
        f"{occupancy_c:.2f}; dispatch thread in the engine "
        f"{share['busy_share']:.1%} of the burst ({share['ms_per_call']:.1f}"
        f" ms a call, host /64 resize {share['resize_share']:.1%} of the "
        f"burst); {card}")
    log(f"[12] one client, {SERVE_PAIRS} in a row (the B=1 bucket): "
        f"latency p50/p90/p99 {lat_s['p50']:.1f} / {lat_s['p90']:.1f} / "
        f"{lat_s['p99']:.1f} ms; dispatch in the engine "
        f"{share_s['ms_per_call']:.1f} ms a call; {SERVE_JSON} JSON (base64 "
        f"PNG) requests: the raw route's bytes; /healthz {health}; /metrics "
        f"requests {m_all['requests']} errors {m_all['errors']}")
    log(f"[12] SIGTERM during a burst of {SERVE_PAIRS}: {len(drained)} "
        f"answered 200, exit code {rc}; the server's totals: {final}; K1 "
        f"launches in the CLI {child['launches']} = 5 x ({final['batches']} "
        f"batches + {warm} warm-up forwards); peak {child['peak_mib']:.0f} "
        f"MiB")

    # 4. fidelity: a float32 parity-mode server in this process, each
    # response against the engine's own flow_from_pair
    engine = FlowEngine(PWCDCNet(), sd, flow_scale=20.0, device="cuda")
    server = FlowServer(engine, max_batch=8, max_delay_ms=5)
    httpd = make_http_server(server, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        engine.flow_from_pairs([pairs[0][0]] * 8, [pairs[0][1]] * 8)
        before = counter.launches
        parity, _ = burst(httpd.server_address[1],
                          [(i, bodies[i]) for i in range(SERVE_PAIRS)], raw,
                          8)
        launched_p = counter.launches - before
        batches_p = server.metrics.snapshot()["batches"]
    finally:
        httpd.shutdown()
        server.close()
        httpd.server_close()
    assert launched_p == 5 * batches_p, (launched_p, batches_p)
    epes = []
    for i, status, data, _ in parity:
        assert status == 200, (i, status)
        epes.append(epe(flo_array(data, FULL_H, FULL_W),
                        engine.flow_from_pair(*pairs[i])))
    log(f"[12] float32 parity-mode server, {len(parity)} concurrent "
        f"requests in {batches_p} batches: each response against "
        f"flow_from_pair of its pair, mean EPE max {max(epes)!r} (bound "
        f"1e-4); K1 {launched_p} launches")
    assert max(epes) <= 1e-4, max(epes)

    # 7. the engine alone, bfloat16 fast (the CLI's model), resize mode
    fast = FlowEngine(PWCDCNet(dtype=torch.bfloat16, precision="fast"), sd,
                      flow_scale=20.0, device="cuda")
    im1s, im2s = [p[0] for p in pairs[:8]], [p[1] for p in pairs[:8]]
    fast.flow_from_pairs(im1s, im2s)
    fast.flow_from_pair(*pairs[0])
    t0 = time.perf_counter()
    for _ in range(4):
        fast.flow_from_pairs(im1s, im2s)
    alone_b8 = 32 / (time.perf_counter() - t0)
    lat1 = []
    for a, b in pairs:
        t0 = time.perf_counter()
        fast.flow_from_pair(a, b)
        lat1.append(time.perf_counter() - t0)
    alone_b1 = percentiles(lat1)
    log(f"[12] FlowEngine.flow_from_pairs alone, bfloat16 fast, resize, "
        f"{FULL_H}x{FULL_W}: B=8 {alone_b8!r} pairs/s (the server: "
        f"{rps / alone_b8:.2f} of it); B=1 latency p50/p90/p99 "
        f"{alone_b1['p50']:.1f} / {alone_b1['p90']:.1f} / "
        f"{alone_b1['p99']:.1f} ms; phase 12 took "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return {"requests_per_s": rps, "concurrent_wall_s": wall_c,
            "latency_ms": lat_c, "sequential_latency_ms": lat_s,
            "mean_occupancy": occupancy_c, "batches": m_c["batches"],
            "dispatch": share, "dispatch_sequential": share_s,
            "peak_mib": child["peak_mib"], "startup_s": startup_s,
            "final_metrics": final, "drained": len(drained),
            "launches_cli": child["launches"], "launches_parity": launched_p,
            "parity_epe_max": max(epes),
            "engine_alone_b8_pairs_per_s": alone_b8,
            "engine_alone_b1_latency_ms": alone_b1,
            "server_over_engine": rps / alone_b8, "card": card}


# ------------------------------------------------------------ phase 13

# the shapes an artifact of dynamic="all" runs at: Sintel padded (B=1 and
# B=4), a 64-pixel side (level 6 is 1 pixel wide), 1080p (K2's domain)
EXPORT_SHAPES = ((1, 448, 1024), (4, 448, 1024), (1, 64, 64),
                 (2, 1088, 1920))


def artifact_check(fn, model, b, h, w, counter, seed: int):
    """``fn`` against the eager ``model`` ×20 on ``parity_check``'s input
    (``RandomState(seed).rand`` of the NHWC shape, transposed): its
    parity report and its K1 launches."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.utils.metrics import parity_report
    x = np.random.RandomState(seed).rand(b, h, w, 6).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 3, 1, 2))).cuda()
    before = counter.launches
    got = fn(xt)
    torch.cuda.synchronize()
    launched = counter.launches - before
    with torch.inference_mode():
        want = model(xt) * 20.0
    rep = parity_report(got.permute(0, 2, 3, 1).cpu().numpy(),
                        want.permute(0, 2, 3, 1).cpu().numpy())
    return xt, got, rep, launched


def phase_export(sd, tmp, counter, card: str):
    """Export and parity on the card.  Returns a dict of its results."""
    import contextlib
    import io
    import torch
    from opticalflow_tpu_torch.cli import parity as parity_cli
    from opticalflow_tpu_torch.export import export_program, load_exported
    from opticalflow_tpu_torch.io.images import decode_png
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.models.torch_import import reference_state_dict
    from opticalflow_tpu_torch.scripts._timing import cuda_ms
    from opticalflow_tpu_torch.utils.metrics import parity_report

    t_phase = time.perf_counter()
    weights = reference_state_dict(sd)

    def parity_model(use_cuda_corr=True):
        m = PWCDCNet(use_cuda_corr=use_cuda_corr)
        m.load_state_dict(weights)
        return m.cuda().eval()

    # 1. the float32 parity model, with the kernel's operator, dynamic="all"
    model = parity_model()
    path = os.path.join(tmp, "kernel.pt2")
    t0 = time.perf_counter()
    export_program(model, path, dynamic="all")
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = load_exported(path)
    load_s = time.perf_counter() - t0
    assert art.metadata["precision"] == "highest", art.metadata
    # 3. the same model with the plain correlation, exported at the first
    # shape (a dynamic export of its 405 shifted products traces for 95 s
    # on a CPU core, a static one for 19 s)
    plain_model = parity_model(use_cuda_corr=False)
    plain_path = os.path.join(tmp, "plain.pt2")
    b0, h0, w0 = EXPORT_SHAPES[0]
    t0 = time.perf_counter()
    export_program(plain_model, plain_path, input_shape=(b0, 6, h0, w0))
    plain_export_s = time.perf_counter() - t0
    plain = load_exported(plain_path)
    log(f"[13] exported the float32 parity model (dynamic='all') in "
        f"{export_s:.1f} s (loaded in {load_s:.1f} s), with the plain "
        f"correlation at {b0}x6x{h0}x{w0} in {plain_export_s:.1f} s")

    # 2. each shape: the eager model's flow, K1 5 times a call; at the
    # first, the plain artifact against the kernel artifact
    rows = []
    for k, (b, h, w) in enumerate(EXPORT_SHAPES):
        xt, got, rep, launched = artifact_check(art, model, b, h, w, counter,
                                                seed=k)
        n = 20 if b * h * w <= 448 * 1024 else 5
        with torch.inference_mode():
            ms = cuda_ms(lambda _: art(xt), n)
            ms_eager = cuda_ms(lambda _: model(xt) * 20.0, n)
        row = {"shape": [b, 6, h, w], "epe_mean": rep["epe_mean"],
               "agree@0.25": rep["agree@0.25"], "launches": launched,
               "ms": ms, "eager_ms": ms_eager}
        rows.append(row)
        log(f"[13] artifact at {b}x6x{h}x{w}: against the eager model epe_mean "
            f"{rep['epe_mean']!r}, agree@0.25 {rep['agree@0.25']}% (bounds "
            f"< 1e-5, 100); K1 {launched} launches; forward by CUDA events: "
            f"artifact {ms:.3f} ms, eager {ms_eager:.3f} ms")
        assert rep["epe_mean"] < 1e-5 and rep["agree@0.25"] == 100.0, rep
        assert launched == 5, launched
        if k:
            continue
        before = counter.launches
        got_plain = plain(xt)
        torch.cuda.synchronize()
        plain_launched = counter.launches - before
        rep_plain = parity_report(got_plain.permute(0, 2, 3, 1).cpu().numpy(),
                                  got.permute(0, 2, 3, 1).cpu().numpy())
        row.update({"plain_vs_kernel_epe_mean": rep_plain["epe_mean"],
                    "plain_vs_kernel_agree@0.25": rep_plain["agree@0.25"],
                    "plain_launches": plain_launched,
                    "plain_ms": cuda_ms(lambda _: plain(xt), 5)})
        log(f"[13] the plain artifact at {b}x6x{h}x{w} against the kernel "
            f"artifact: epe_mean {rep_plain['epe_mean']!r}, agree@0.25 "
            f"{rep_plain['agree@0.25']}% (the same bounds); K1 "
            f"{plain_launched}; forward {row['plain_ms']:.3f} ms")
        assert rep_plain["epe_mean"] < 1e-5, rep_plain
        assert rep_plain["agree@0.25"] == 100.0, rep_plain
        assert plain_launched == 0, plain_launched

    # the host's cost of a call through the PyTorch operator (the node an
    # artifact holds) beside the wrapper the eager model calls, at level 6
    # of 448x1024 (the smallest launch of a forward), in turns
    from opticalflow_tpu_torch.ops.corr_cuda import correlation_cuda
    from opticalflow_tpu_torch.scripts._timing import host_ms
    g = torch.Generator(device="cuda").manual_seed(13)
    f1, f2 = (torch.randn(1, 196, 7, 16, generator=g, device="cuda")
              for _ in range(2))
    op = torch.ops.opticalflow_tpu_torch.correlation
    issue_us = {"operator": [], "wrapper": []}
    with torch.inference_mode():
        for _ in range(2):
            issue_us["wrapper"].append(host_ms(
                lambda _: correlation_cuda(f1, f2), 2000) * 1e3)
            issue_us["operator"].append(host_ms(
                lambda _: op(f1, f2, 4), 2000) * 1e3)
    log(f"[13] host time to issue one K1 call at 1x196x7x16 (2000 calls, "
        f"twice each, in turns): through torch.ops.opticalflow_tpu_torch."
        f"correlation {[round(v, 2) for v in issue_us['operator']]} us, the "
        f"ctypes wrapper alone {[round(v, 2) for v in issue_us['wrapper']]} "
        f"us")

    # 4. the parity CLI at 1x448x1024: exports (static), checks, reports
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    png = os.path.join(tmp, "parity.png")
    buf = io.StringIO()
    before = counter.launches
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = parity_cli.main(["--ckpt", ckpt, "--artifact",
                              os.path.join(tmp, "model.pt2"), "--shape", "1",
                              "448", "1024", "--report-image", png,
                              "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    cli_launches = counter.launches - before
    text = buf.getvalue()
    rep_cli = json.loads(text[text.index("{"):text.rindex("}") + 1])
    with open(png, "rb") as f:
        fig = decode_png(f.read())
    log(f"[13] cli/parity --shape 1 448 1024: rc {rc}, "
        f"{text.strip().splitlines()[-1]!r}, epe_mean "
        f"{rep_cli['epe_mean']!r}, report {fig.shape}, {cli_s:.1f} s, K1 "
        f"{cli_launches} launches; phase 13 took "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    assert rc == 0 and "PARITY: PASS" in text, text[-400:]
    assert fig.ndim == 3 and fig.shape[2] == 3, fig.shape
    assert cli_launches == 10, cli_launches    # the model's and the artifact's
    return {"export_s": export_s, "load_s": load_s,
            "plain_export_s": plain_export_s, "shapes": rows,
            "issue_us": issue_us,
            "launches": sum(r["launches"] for r in rows) + cli_launches,
            "cli": {"rc": rc, "epe_mean": rep_cli["epe_mean"],
                    "seconds": cli_s, "launches": cli_launches},
            "card": card}


# ------------------------------------------------------------ phase 14

# data parallelism on the one card: two gloo ranks share cuda:0 (NCCL
# refuses two ranks on one device), and a one-rank NCCL group; the global
# training batch is phase 8's 4x320x896 with KITTI-like valid masks that
# differ between the ranks' halves
DP_RANKS = 2
DP_FAST_STEPS = 5
ONE_RANK_STEPS = 3
SPATIAL_H, SPATIAL_W = 1024, 1920
SPATIAL_HALO = 256              # slab 512 = 2 x halo: the exact case
# slab 512 > 2 x halo: rank 0's window is rows 0-768, rank 1's 256-1024, the
# windows of the one-process tiled path at tile 512, halo 2 x 128
WIDE_HALO = 128
TILE_H, TILE_HALO = 512, 64
# the video runner over the mesh: a 448x1024 clip whose 9 pairs at B=4 make
# windows of 4, 4 and 1 (a partial last window), 2 pairs a rank a window
DP_VIDEO_FRAMES, DP_VIDEO_B = 10, 4
# one rank of the 2-rank world (launched by torch.distributed.run): the
# parity step, fast steps, a lockstep server and both spatial paths, each
# path's K1/B1 launches counted in this rank from 0; its numbers to
# dp_rank{R}.json, its tensors to dp_rank{R}.pt
DP_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
tmp, device = sys.argv[2], sys.argv[3]
import torch
from opticalflow_tpu_torch.engine import FlowEngine
from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
from opticalflow_tpu_torch.ops.corr_cuda import (correlation_bwd_cuda,
                                                 correlation_cuda)
from opticalflow_tpu_torch.parallel import mesh as meshlib, spatial
from opticalflow_tpu_torch.serve import FlowServer
from opticalflow_tpu_torch.train import trainer as T

# the backend and the mesh's device are the defaults: gloo, since the two
# ranks outnumber the one card, and the card distributed_init selected
rank, world = meshlib.distributed_init(device=device, timeout_s=600)
mesh = meshlib.make_mesh()
inp = torch.load(os.path.join(tmp, "dp_inputs.pt"), weights_only=False)
out = {"rank": rank, "world": world, "backend": mesh.backend,
       "device": str(mesh.device)}
tensors = {}


def sync():
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def counted(fn):
    sync()
    correlation_cuda.launches = correlation_bwd_cuda.launches = 0
    t0 = time.perf_counter()
    res = fn()
    sync()
    return res, (time.perf_counter() - t0) * 1e3, {
        "correlation_fwd": correlation_cuda.launches,
        "correlation_bwd": correlation_bwd_cuda.launches}


def model_of(precision):
    m = PWCDCNet(precision=precision)
    m.load_state_dict(inp["sd"])
    return meshlib.replicate(m.to(mesh.device), mesh)


cfg = T.TrainConfig(loss="multiscale", optimizer="adamw", lr=1e-4,
                    weight_decay=1e-4, grad_clip=1.0)
local = meshlib.shard_batch(inp["batch"], mesh)
# (a) one float32 parity-mode step on this rank's half
model = model_of("highest")
state, opt = T.create_train_state(model, cfg)
step = T.make_train_step(model, opt, cfg, mesh=mesh)
(state, m), ms, launches = counted(lambda: step(state, local))
out["parity"] = {"metrics": {k: float(v) for k, v in m.items()}, "ms": ms,
                 "launches": launches}
tensors["grads"] = {n: p.grad.cpu() for n, p in model.named_parameters()}
tensors["params"] = {n: p.detach().cpu()
                     for n, p in model.named_parameters()}
# (a) fast-mode steps, the batch on the card (NHWC, as phase 8 feeds it)
model = model_of("fast")
state, opt = T.create_train_state(model, cfg)
step = T.make_train_step(model, opt, cfg, mesh=mesh)
dev = {k: v.permute(0, 2, 3, 1).contiguous() if v.dim() == 4 else v
       for k, v in T.batch_to_device(local, mesh.device).items()}
state, m = step(state, dev)                     # warm-up
float(m["loss"])
fast = []
for _ in range(int(inp["fast_steps"])):
    (state, m), ms, launches = counted(lambda: step(state, dev))
    fast.append({"loss": float(m["loss"]), "ms": ms, **launches})
out["fast"] = fast
# the step's collectives alone: the gradients' one coalesced all-reduce
# (every gradient in one float32 buffer) and a one-element all-reduce (the
# masked means' counts, the stop flag)
flat = torch.cat([p.grad.reshape(-1) for p in model.parameters()
                  if p.grad is not None])
for name, t in (("allreduce_grads", flat),
                ("allreduce_one", torch.zeros(1, device=mesh.device))):
    meshlib.all_reduce_(t, mesh)                # warm-up
    out[name] = {"bytes": t.numel() * t.element_size(), "ms": [
        counted(lambda: meshlib.all_reduce_(t, mesh))[1] for _ in range(5)]}
del model, state, opt, step, dev, flat
# (d) a float32 parity-mode lockstep server: one request on every rank
engine = FlowEngine(PWCDCNet(precision="highest"), inp["sd"],
                    flow_scale=20.0, mesh=mesh)
server = FlowServer(engine, max_batch=world, max_delay_ms=1)
im1, im2 = inp["serve_pair"]
server.flow(im1, im2, size_mode="pad")          # warm-up
flow, ms, launches = counted(lambda: server.flow(im1, im2, size_mode="pad"))
server.close()
out["serve"] = {"ms": ms, "launches": launches,
                "buckets": server.bucket_sizes}
tensors["serve"] = flow
# (e) spatial inference of one 1024x1920 frame
sm = engine.model
x = inp["x_spatial"].to(mesh.device)
loc = x.shape[2] // world
slab = x[:, :, rank * loc:(rank + 1) * loc].contiguous()
halo = int(inp["halo"])
for name, fn in (
        ("halo", lambda: spatial.halo_exchange_quarter_flow(
            sm, slab, halo=halo, mesh=mesh)),
        ("halo_wide", lambda: spatial.halo_exchange_quarter_flow(
            sm, slab, halo=int(inp["wide_halo"]), mesh=mesh)),
        ("tiled", lambda: spatial.tiled_quarter_flow(
            sm, x, tile_h=int(inp["tile_h"]), halo=int(inp["tile_halo"]),
            mesh=mesh))):
    fn()                                        # warm-up
    q, ms, launches = counted(fn)
    out[name] = {"ms": ms, "launches": launches}
    tensors[name] = q.cpu()
# (f) the video runner over the mesh: rank 0 reads the clip, every rank
# yields every pair's triple
import hashlib
import numpy as np
from opticalflow_tpu_torch.video import VideoFlowRunner
runner = VideoFlowRunner(model_of("highest"), None,
                         batch=int(inp["video_b"]), mesh=mesh)
frames = iter(inp["video_frames"]) if rank == 0 else None
triples, ms, launches = counted(lambda: list(runner.run(frames)))
digest = hashlib.sha256()
for a, b, _ in triples:
    digest.update(a.tobytes())
    digest.update(b.tobytes())
out["video"] = {"ms": ms, "launches": launches, "pairs": len(triples),
                "frames_sha256": digest.hexdigest(),
                "stats": dict(runner.stats)}
tensors["video"] = torch.from_numpy(np.stack([f for _, _, f in triples]))
torch.save(tensors, os.path.join(tmp, f"dp_rank{rank}.pt"))
with open(os.path.join(tmp, f"dp_rank{rank}.json"), "w") as f:
    json.dump(out, f)
meshlib.shutdown()
"""
# the eval CLI as one rank of a torch.distributed.run launch: its K1 count
# in this rank from 0 and what it printed, to eval_rank{R}.json in the
# directory argv[2] (the ranks' prints would interleave on one pipe)
EVAL_CHILD = r"""
import contextlib, io, json, os, sys
sys.path.insert(0, sys.argv[1])
from opticalflow_tpu_torch.cli import infer_kitti
from opticalflow_tpu_torch.ops.corr_cuda import correlation_cuda
correlation_cuda.launches = 0
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    rc = infer_kitti.main(sys.argv[3:])
rank = int(os.environ["RANK"])
with open(os.path.join(sys.argv[2], f"eval_rank{rank}.json"), "w") as f:
    json.dump({"rank": rank, "rc": rc, "printed": printed.getvalue(),
               "launches": correlation_cuda.launches}, f)
sys.exit(rc)
"""
# what the backends carry for two ranks on one card: gloo's point-to-point
# send/recv of a card's tensor, and an NCCL group (expected to refuse)
PROBE_CHILD = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from opticalflow_tpu_torch.parallel import mesh as meshlib
what = sys.argv[2]
rank, world = meshlib.distributed_init(
    backend="gloo" if what == "gloo_p2p" else "nccl", device="cuda:0",
    timeout_s=60)
t = torch.full((4,), float(rank), device="cuda:0")
if what == "gloo_p2p":
    if rank == 0:
        dist.send(t, dst=1)
    else:
        dist.recv(t, src=0)
    torch.cuda.synchronize()
    print(f"PROBE {what} rank {rank}: {t.tolist()}", flush=True)
else:
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print(f"PROBE {what} rank {rank}: all_reduce {t.tolist()}", flush=True)
meshlib.shutdown()
"""


def dp_batch():
    """Phase 8's batch with KITTI-like valid masks: the first half ~80%
    valid, the second a sparse lower band (KITTI's LiDAR GT: the top 40%
    of the rows empty, ~35% of the rest valid), so the ranks' masked means
    differ and only global denominators give the one-process step."""
    import numpy as np
    batch = train_batch()
    rng = np.random.RandomState(14)
    valid = (rng.rand(TRAIN_B, TRAIN_H, TRAIN_W) > 0.2).astype(np.float32)
    half = TRAIN_B // 2
    band = (rng.rand(TRAIN_B - half, TRAIN_H, TRAIN_W) < 0.35)
    band[:, : int(TRAIN_H * 0.4)] = False
    valid[half:] = band
    batch["valid"] = valid
    return batch


def torchrun(tmp: str, name: str, nproc: int, script: str, args,
             timeout: float):
    """``python -m torch.distributed.run --standalone`` of ``script`` (a
    source string, written to ``tmp/name.py``) on ``nproc`` ranks; returns
    (exit code, output, seconds).  A run past ``timeout`` is killed with
    its ranks."""
    import signal
    path = os.path.join(tmp, f"{name}.py")
    with open(path, "w") as f:
        f.write(script)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", path, *args], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        return 124, text, time.perf_counter() - t0
    return proc.returncode, text, time.perf_counter() - t0


def parity_step(sd_ref, batch, cfg):
    """One float32 parity-mode step in this process: (metrics, gradients,
    parameters after), on the host."""
    import torch
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.train import trainer as T
    model = PWCDCNet(precision="highest")
    model.load_state_dict(sd_ref)
    model = model.cuda()
    state, opt = T.create_train_state(model, cfg)
    _, m = T.make_train_step(model, opt, cfg)(state, batch)
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: p.detach().cpu() for n, p in model.named_parameters()})


def worst_rel(a, b, base=None):
    """max over tensors of max|a - b| / max|base| (base defaults to b), a
    tensor whose base vanishes measured against a millionth of the
    largest; and its name."""
    base = b if base is None else base
    top = max(float(v.abs().max()) for v in base.values())
    return max(((float((a[n] - b[n]).abs().max())
                 / max(float(base[n].abs().max()), 1e-6 * top)), n)
               for n in b)


def ulps(p):
    """One float32 ulp of each element of ``p``."""
    import torch
    a = p.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def worst_update(a, b, before):
    """worst_rel of the updates ``a - before`` against ``b - before`` of
    the parameters ``a``, ``b`` after one step, at the resolution at which
    a float32 parameter holds its update: each element's difference less
    one ulp of the updated parameter (a tensor whose largest update spans
    a few hundred ulps reads one ulp of rounding as 1/hundreds); and the
    name.  Beside it, for the tensor worst without that allowance, its
    largest difference in ulps of that element, and its largest update in
    the same ulps."""
    upd = {n: b[n] - before[n] for n in b}
    top = max(float(v.abs().max()) for v in upd.values())
    ulp = {n: ulps(a[n]).maximum(ulps(b[n])) for n in b}
    ratio, name = max(
        (float(((a[n] - b[n]).abs() - ulp[n]).clamp(min=0).max())
         / max(float(upd[n].abs().max()), 1e-6 * top), n) for n in b)
    _, raw = worst_rel({n: a[n] - before[n] for n in b}, upd)
    diff = (a[raw] - b[raw]).abs().reshape(-1)
    at = int(diff.argmax())
    u = float(ulp[raw].reshape(-1)[at])
    in_ulps = (float(diff[at]) / u, float(upd[raw].abs().max()) / u)
    return ratio, name, raw, in_ulps


def phase_data_parallel(sd, tmp, counters, card: str, single_step_ms):
    """Data parallelism on the card: (a)-(e) of the docstring's phase 14.
    Returns a dict of its results."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.cli import infer_kitti
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.io.kitti import read_flow_png
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.models.torch_import import reference_state_dict
    from opticalflow_tpu_torch.parallel import mesh as meshlib
    from opticalflow_tpu_torch.parallel import spatial
    from opticalflow_tpu_torch.train import trainer as T
    from opticalflow_tpu_torch.video import VideoFlowRunner
    import hashlib

    corr_fwd, corr_bwd = counters
    t_phase = time.perf_counter()
    sd_ref = reference_state_dict(sd)
    batch = dp_batch()
    fractions = batch["valid"].reshape(TRAIN_B, -1).mean(1)
    cfg = T.TrainConfig(loss="multiscale", optimizer="adamw", lr=1e-4,
                        weight_decay=1e-4, grad_clip=1.0)
    rng = np.random.RandomState(14)
    serve_pair = moving_pair(rng, FULL_H, FULL_W)
    s1, s2 = moving_pair(rng, SPATIAL_H, SPATIAL_W)
    x = torch.from_numpy(np.concatenate([s1[..., ::-1], s2[..., ::-1]], -1)
                         .astype(np.float32) / 255.0).permute(2, 0, 1)[None]
    x = x.contiguous()
    vframes = moving_frames(rng, DP_VIDEO_FRAMES, FULL_H, FULL_W)
    torch.save({"sd": sd_ref, "batch": batch, "serve_pair": serve_pair,
                "x_spatial": x, "fast_steps": DP_FAST_STEPS,
                "halo": SPATIAL_HALO, "wide_halo": WIDE_HALO,
                "tile_h": TILE_H, "tile_halo": TILE_HALO,
                "video_frames": vframes, "video_b": DP_VIDEO_B},
               os.path.join(tmp, "dp_inputs.pt"))

    # the one-process references: the parity step twice (cuDNN's
    # run-to-run spread), the served flow, the monolithic and tiled flows
    m1, g1, p1 = parity_step(sd_ref, batch, cfg)
    m2, g2, p2 = parity_step(sd_ref, batch, cfg)
    before = {n: v.cpu() for n, v in sd_ref.items()}
    upd = lambda p: {n: p[n] - before[n] for n in p}   # noqa: E731
    spread_g, _ = worst_rel(g2, g1)
    spread_u = worst_update(p2, p1, before)[0]
    engine = FlowEngine(PWCDCNet(precision="highest"), sd, flow_scale=20.0,
                        device="cuda")
    serve_ref = engine.flow_from_pair(*serve_pair, size_mode="pad")
    with torch.inference_mode():
        xs = x.cuda()
        mono = engine.model(xs).cpu()
        tiled_one = spatial.tiled_quarter_flow(
            engine.model, xs, tile_h=TILE_H, halo=TILE_HALO).cpu()
        wide_one = spatial.tiled_quarter_flow(
            engine.model, xs, tile_h=SPATIAL_H // DP_RANKS,
            halo=2 * WIDE_HALO).cpu()
    video_one = list(VideoFlowRunner(
        PWCDCNet(precision="highest"), sd, batch=DP_VIDEO_B,
        device="cuda").run(iter(vframes)))
    digest = hashlib.sha256()
    for a, b, _ in video_one:
        digest.update(a.tobytes())
        digest.update(b.tobytes())
    video_sha = digest.hexdigest()

    def video_epe(flows):
        return max(epe(f, r) for f, (_, _, r) in zip(flows, video_one))
    del engine, xs
    torch.cuda.empty_cache()

    # (a, d, e) the 2-rank gloo world, both ranks on cuda:0
    rc, text, wall = torchrun(tmp, "dp_child", DP_RANKS, DP_CHILD, [ROOT, tmp, "cuda:0"],
                              600)
    assert rc == 0, f"the 2-rank world failed ({rc}):\n{text[-6000:]}"
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(tmp, f"dp_rank{r}.json")) as f:
            res = json.load(f)
        res["tensors"] = torch.load(os.path.join(tmp, f"dp_rank{r}.pt"),
                                    weights_only=False)
        ranks.append(res)
    r0 = ranks[0]
    assert all((r["backend"], r["device"]) == ("gloo", "cuda:0")
               for r in ranks), [(r["backend"], r["device"]) for r in ranks]
    log(f"[14] 2 ranks on {r0['device']} over {r0['backend']} (launched by "
        f"torch.distributed.run, {wall:.1f} s with start-up); valid "
        f"fractions of the 4 samples {[round(float(v), 4) for v in fractions]}")
    for r in ranks[1:]:                  # one global step: the ranks agree
        assert r["parity"]["metrics"] == r0["parity"]["metrics"]
        for n, v in r0["tensors"]["params"].items():
            assert torch.equal(v, r["tensors"]["params"][n]), n
    pm = r0["parity"]["metrics"]
    ratio_g, name_g = worst_rel(r0["tensors"]["grads"], g1)
    raw_u, _ = worst_rel(upd(r0["tensors"]["params"]), upd(p1))
    ratio_u, name_u, raw_name, raw_ulps = worst_update(
        r0["tensors"]["params"], p1, before)
    bound_g = max(1e-3, 4 * spread_g)
    bound_u = max(1e-3, 4 * spread_u)
    log(f"[14] (a) parity step, 2 ranks x 2x320x896 against 1 process x "
        f"4x320x896: loss {pm['loss']!r} / {m1['loss']!r}, grad norm "
        f"{pm['grad_norm']!r} / {m1['grad_norm']!r}, epe {pm['epe']!r} / "
        f"{m1['epe']!r}; worst parameter max|grad - grad(1 process)| / "
        f"max|grad| {ratio_g:.3e} ({name_g}; bound {bound_g:.3e} = max(1e-3, "
        f"4 x the one process's run-to-run {spread_g:.3e})); the AdamW "
        f"update {ratio_u:.3e} beyond one float32 ulp of the parameter "
        f"({name_u}; bound {bound_u:.3e}, run-to-run {spread_u:.3e}; "
        f"without the ulp {raw_u:.3e}, {raw_name}: its largest difference "
        f"{raw_ulps[0]:.2f} ulps, its largest update {raw_ulps[1]:.1f} "
        f"ulps); K1/B1 launches a rank "
        f"{[r['parity']['launches'] for r in ranks]}")
    assert abs(pm["loss"] - m1["loss"]) <= max(
        1e-5 * abs(m1["loss"]), 4 * abs(m2["loss"] - m1["loss"])), (pm, m1)
    assert abs(pm["grad_norm"] - m1["grad_norm"]) <= max(
        1e-4 * m1["grad_norm"], 4 * abs(m2["grad_norm"] - m1["grad_norm"]))
    assert ratio_g <= bound_g and ratio_u <= bound_u, (ratio_g, ratio_u)
    for r in ranks:
        assert r["parity"]["launches"] == {"correlation_fwd": 5,
                                           "correlation_bwd": 5}, r
    fast_ms = [[s["ms"] for s in r["fast"]] for r in ranks]
    rank_ms = [float(np.median(v)) for v in fast_ms]
    ar_ms = [float(np.median(r["allreduce_grads"]["ms"])) for r in ranks]
    ar1_ms = [float(np.median(r["allreduce_one"]["ms"])) for r in ranks]
    log(f"[14] (a) {DP_FAST_STEPS} fast steps a rank after a warm-up, 2 "
        f"ranks x 2x320x896 sharing the card: ms per step per rank "
        f"{[[round(v, 2) for v in ms] for ms in fast_ms]} (medians "
        f"{[round(v, 2) for v in rank_ms]}), losses "
        f"{[round(s['loss'], 6) for s in r0['fast']]}; one process x "
        f"4x320x896 in phase 8: {single_step_ms:.2f} ms; alone, the "
        f"gradients' all-reduce ({r0['allreduce_grads']['bytes']} bytes "
        f"staged through the host) {[round(v, 2) for v in ar_ms]} ms a "
        f"rank, a one-element all-reduce {[round(v, 3) for v in ar1_ms]} "
        f"ms (medians of 5); {card}")
    for r in ranks:
        assert all(s["correlation_fwd"] == 5 and s["correlation_bwd"] == 5
                   for s in r["fast"]), r["fast"]
        assert np.isfinite([s["loss"] for s in r["fast"]]).all()
    for r in ranks:
        e = epe(r["tensors"]["serve"], serve_ref)
        assert r["serve"]["buckets"] == [DP_RANKS], r["serve"]
        assert r["serve"]["launches"]["correlation_fwd"] == 5, r["serve"]
        assert e < 1e-4, e
    log(f"[14] (d) lockstep FlowServer (float32 parity, max_batch 2: one "
        f"436x1024 request a rank): mean EPE against flow_from_pair "
        f"{[epe(r['tensors']['serve'], serve_ref) for r in ranks]} (bound "
        f"1e-4), ms a request {[round(r['serve']['ms'], 2) for r in ranks]}"
        f", K1 a rank {[r['serve']['launches']['correlation_fwd'] for r in ranks]}")
    halo_err = max(float((r["tensors"]["halo"] - mono).abs().max())
                   for r in ranks)
    wide_err = max(float((r["tensors"]["halo_wide"] - wide_one).abs().max())
                   for r in ranks)
    tiled_err = max(float((r["tensors"]["tiled"] - tiled_one).abs().max())
                    for r in ranks)
    seam = (tiled_one - mono).abs().numpy()
    log(f"[14] (e) 1x{SPATIAL_H}x{SPATIAL_W} (monolithic flow: mean "
        f"|u|, |v| {[round(float(v), 6) for v in mono.abs().mean((0, 2, 3))]}"
        f" network units; random weights): halo exchange (halo "
        f"{SPATIAL_HALO}, slab {SPATIAL_H // DP_RANKS}) against the "
        f"monolithic forward max|diff| {halo_err:.3e} (bound 1e-4); halo "
        f"{WIDE_HALO} (slab {SPATIAL_H // DP_RANKS} > 2 x halo) against "
        f"the one-process tiled path with its windows (tile_h "
        f"{SPATIAL_H // DP_RANKS}, halo {2 * WIDE_HALO}) {wide_err:.3e} "
        f"(bound 1e-4); tiled "
        f"(tile_h {TILE_H}, halo {TILE_HALO}) over 2 ranks against 1 "
        f"process {tiled_err:.3e} (bound 1e-4); the tiled result's seam "
        f"deviation from the monolithic one: median "
        f"{float(np.median(seam)):.3e}, mean {float(seam.mean()):.3e}, "
        f"border rows (8 top/bottom) {float(seam[:, :, :8].mean()):.3e} / "
        f"{float(seam[:, :, -8:].mean()):.3e} network units; ms halo "
        f"{[round(r['halo']['ms'], 2) for r in ranks]}, halo {WIDE_HALO} "
        f"{[round(r['halo_wide']['ms'], 2) for r in ranks]}, tiled "
        f"{[round(r['tiled']['ms'], 2) for r in ranks]}; K1 a rank halo "
        f"{[r['halo']['launches']['correlation_fwd'] for r in ranks]}, halo "
        f"{WIDE_HALO} "
        f"{[r['halo_wide']['launches']['correlation_fwd'] for r in ranks]}, "
        f"tiled "
        f"{[r['tiled']['launches']['correlation_fwd'] for r in ranks]}")
    assert halo_err < 1e-4 and wide_err < 1e-4 and tiled_err < 1e-4, (
        halo_err, wide_err, tiled_err)
    for r in ranks:
        assert r["halo"]["launches"]["correlation_fwd"] == 5
        assert r["halo_wide"]["launches"]["correlation_fwd"] == 5
        assert r["tiled"]["launches"]["correlation_fwd"] == 5
    video_windows = -(-(DP_VIDEO_FRAMES - 1) // DP_VIDEO_B)
    video_errs = [video_epe(r["tensors"]["video"].numpy()) for r in ranks]
    log(f"[14] (f) VideoFlowRunner(mesh=) over {DP_VIDEO_FRAMES} frames "
        f"{FULL_H}x{FULL_W} at B={DP_VIDEO_B} ({video_windows} windows, the "
        f"last partial; {DP_VIDEO_B // DP_RANKS} pairs a rank a window), "
        f"float32 parity: worst pair's mean EPE against the one-process "
        f"runner a rank {video_errs} (bound 1e-4); the triples' frames "
        f"equal to one process's on every rank "
        f"{[r['video']['frames_sha256'] == video_sha for r in ranks]}; "
        f"bytes broadcast a rank "
        f"{[r['video']['stats']['bytes_broadcast'] for r in ranks]}; ms "
        f"{[round(r['video']['ms'], 2) for r in ranks]}; K1 a rank "
        f"{[r['video']['launches']['correlation_fwd'] for r in ranks]}")
    for r, e in zip(ranks, video_errs):
        assert r["video"]["pairs"] == DP_VIDEO_FRAMES - 1, r["video"]
        assert r["video"]["frames_sha256"] == video_sha
        assert e <= 1e-4, video_errs
        assert r["video"]["launches"]["correlation_fwd"] == \
            5 * video_windows, r["video"]

    # (b) a one-rank NCCL group (--data-parallel all with nothing launched)
    # against no mesh, three fast-mode steps each, in this process
    def fast_steps(mesh):
        model = PWCDCNet(precision="fast")
        model.load_state_dict(sd_ref)
        model = model.cuda()
        state, opt = T.create_train_state(model, cfg)
        step = T.make_train_step(model, opt, cfg, mesh=mesh)
        dev = {k: v.permute(0, 2, 3, 1).contiguous() if v.dim() == 4 else v
               for k, v in T.batch_to_device(batch, "cuda").items()}
        losses, ms = [], []
        f0, b0 = corr_fwd.launches, corr_bwd.launches
        for _ in range(ONE_RANK_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, dev)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms, (corr_fwd.launches - f0, corr_bwd.launches - b0)

    plain_a = fast_steps(None)
    plain_b = fast_steps(None)
    mesh = meshlib.resolve_data_parallel("all", device="cuda:0")
    try:
        assert (mesh.world, mesh.backend) == (1, "nccl"), mesh
        nccl = fast_steps(mesh)
        vmodel = PWCDCNet(precision="highest")
        vmodel.load_state_dict(sd_ref)
        runner = VideoFlowRunner(vmodel, None, batch=DP_VIDEO_B, mesh=mesh)
        f0 = corr_fwd.launches
        nccl_video = list(runner.run(iter(vframes)))
        nccl_video_k1 = corr_fwd.launches - f0
        nccl_video_err = video_epe([f for _, _, f in nccl_video])
        flat = torch.zeros(sum(v.numel() for v in g1.values()),
                           device="cuda")
        meshlib.all_reduce_(flat, mesh)             # warm-up
        nccl_ar = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            meshlib.all_reduce_(flat, mesh)
            torch.cuda.synchronize()
            nccl_ar.append((time.perf_counter() - t0) * 1e3)
        del flat
    finally:
        meshlib.shutdown()
    nccl_version = ".".join(map(str, torch.cuda.nccl.version()))
    spread = max(abs(a - b) for a, b in zip(plain_a[0], plain_b[0]))
    dev_nccl = max(abs(a - b) for a, b in zip(nccl[0], plain_a[0]))
    log(f"[14] (b) one-rank NCCL {nccl_version} group, {ONE_RANK_STEPS} "
        f"fast steps x 4x320x896: losses {nccl[0]} against no mesh "
        f"{plain_a[0]} (max|diff| {dev_nccl:.3e}; no mesh twice "
        f"{spread:.3e}); ms per step {[round(v, 2) for v in nccl[1]]} "
        f"against {[round(v, 2) for v in plain_a[1]]}; the gradients' "
        f"all-reduce alone {[round(v, 3) for v in nccl_ar]} ms; K1/B1 "
        f"launches {nccl[2]}; {card}")
    assert dev_nccl <= max(1e-6 * abs(plain_a[0][0]), 4 * spread), dev_nccl
    assert nccl[2] == (5 * ONE_RANK_STEPS, 5 * ONE_RANK_STEPS), nccl[2]
    log(f"[14] (f) VideoFlowRunner(mesh=) on the one-rank NCCL group, the "
        f"same clip: worst pair's mean EPE against the one-process runner "
        f"{nccl_video_err!r} (bound 1e-4); K1 {nccl_video_k1}")
    assert len(nccl_video) == DP_VIDEO_FRAMES - 1
    assert all(np.array_equal(a, a1) and np.array_equal(b, b1) for
               (a, b, _), (a1, b1, _) in zip(nccl_video, video_one))
    assert nccl_video_err <= 1e-4, nccl_video_err
    assert nccl_video_k1 == 5 * video_windows, nccl_video_k1

    # (c) cli/infer_kitti --data-parallel 2 on phase 9's synthetic tree
    kroot = os.path.join(tmp, "kitti")
    write_kitti_eval_tree(kroot, sd, np.random.RandomState(9))
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    argv = ["--root", kroot, "--ckpt", ckpt, "--size-mode", "pad",
            "--batch", "2"]
    one_dir, two_dir = (os.path.join(tmp, d) for d in ("eval1", "eval2"))
    rc, printed1, wall1 = run_cli(infer_kitti.main, argv + [
        "--save-dir", one_dir, "--device", "cuda"])
    assert rc == 0, rc
    rc, text, wall2 = torchrun(tmp, "eval_child", DP_RANKS, EVAL_CHILD, [
        ROOT, tmp, *argv, "--save-dir", two_dir, "--device", "cuda:0",
        "--data-parallel", str(DP_RANKS)], 600)
    assert rc == 0, f"the 2-rank eval failed ({rc}):\n{text[-6000:]}"
    children = []
    for r in range(DP_RANKS):
        with open(os.path.join(tmp, f"eval_rank{r}.json")) as f:
            children.append(json.load(f))
    printed2 = [float(line.split(":")[1]) for c in children
                for line in c["printed"].splitlines()
                if line.startswith("Mean EPE:")]
    gts = sorted(os.listdir(os.path.join(kroot, "training", "flow_occ")))

    def saved_epe(d):
        vals = []
        for g in gts:
            ref, valid = read_flow_png(os.path.join(kroot, "training",
                                                    "flow_occ", g))
            pred, _ = read_flow_png(os.path.join(d, g))
            e = np.hypot(*(pred - ref).transpose(2, 0, 1))
            vals.append(float(e[valid > 0].mean()))
        return float(np.mean(vals))

    epe1, epe2 = saved_epe(one_dir), saved_epe(two_dir)
    log(f"[14] (c) cli/infer_kitti --data-parallel 2 under "
        f"torch.distributed.run (gloo, both ranks on cuda:0), 3 pairs "
        f"375x1242 at batch 2: mean EPE from the saved PNGs {epe2!r} "
        f"against one process {epe1!r} (|diff| {abs(epe2 - epe1):.3e}, "
        f"bound 1e-4); printed {printed2} (rank 0 only) against "
        f"{printed1}; K1 a rank {[c['launches'] for c in children]}; wall "
        f"{wall2:.1f} s (start-up included) against {wall1:.1f} s")
    assert len(printed2) == 1 and "Mean EPE:" in children[0]["printed"]
    assert [c["rank"] for c in children] == [0, 1]
    assert all(c["rc"] == 0 and c["launches"] == 10 for c in children)
    assert abs(epe2 - epe1) <= 1e-4, (epe1, epe2)

    # what each backend carries for two ranks on one card (recorded, not
    # required: the port's collectives are all-reduce, all-gather and
    # broadcast, which gloo stages through the host)
    probes = {}
    for what in ("gloo_p2p", "nccl_two_ranks"):
        rc, text, _ = torchrun(tmp, what, 2, PROBE_CHILD, [ROOT, what], 180)
        lines = [ln.strip() for ln in text.splitlines()
                 if ln.startswith("PROBE") or "Error" in ln
                 or "Duplicate GPU" in ln or "exitcode" in ln
                 or "Signal" in ln]
        probes[what] = {"rc": rc, "lines": lines[:8]}
        log(f"[14] probe {what}: exit {rc}; " + " | ".join(lines[:8]))
        assert rc != 124, f"probe {what} hung:\n{text[-4000:]}"
    phase_s = time.perf_counter() - t_phase
    log(f"[14] phase 14 took {phase_s:.1f} s; {card}")
    return {
        "valid_fractions": [float(v) for v in fractions],
        "parity": {"metrics": pm, "one_process": m1,
                   "grad_ratio": ratio_g, "update_ratio": ratio_u,
                   "update_ratio_raw": raw_u, "update_raw_ulps": raw_ulps,
                   "grad_spread": spread_g, "update_spread": spread_u},
        "fast_ms_per_rank": fast_ms, "fast_ms_median": rank_ms,
        "allreduce_grads_ms": [r["allreduce_grads"]["ms"] for r in ranks],
        "allreduce_one_ms": [r["allreduce_one"]["ms"] for r in ranks],
        "single_step_ms": single_step_ms,
        "one_rank_nccl": {"nccl": nccl_version, "losses": nccl[0],
                          "ms": nccl[1], "plain_losses": plain_a[0],
                          "allreduce_grads_ms": nccl_ar,
                          "plain_ms": plain_a[1]},
        "eval": {"epe_two_ranks": epe2, "epe_one_process": epe1,
                 "wall_s": wall2},
        "video": {"epe_ranks": video_errs, "epe_one_rank_nccl":
                  nccl_video_err, "ms": [r["video"]["ms"] for r in ranks],
                  "bytes_broadcast": [r["video"]["stats"]["bytes_broadcast"]
                                      for r in ranks]},
        "serve_ms": [r["serve"]["ms"] for r in ranks],
        "spatial": {"halo_err": halo_err, "halo_wide_err": wide_err,
                    "tiled_err": tiled_err,
                    "halo_ms": [r["halo"]["ms"] for r in ranks],
                    "halo_wide_ms": [r["halo_wide"]["ms"] for r in ranks],
                    "tiled_ms": [r["tiled"]["ms"] for r in ranks],
                    "seam_median": float(np.median(seam)),
                    "seam_mean": float(seam.mean())},
        "probes": probes, "phase_s": phase_s, "card": card,
        # each path's launches, per rank
        "launches": {
            "ranks": [{"parity": r["parity"]["launches"],
                       "fast": {k: sum(s[k] for s in r["fast"]) for k in
                                ("correlation_fwd", "correlation_bwd")},
                       "serve": r["serve"]["launches"],
                       "halo": r["halo"]["launches"],
                       "halo_wide": r["halo_wide"]["launches"],
                       "tiled": r["tiled"]["launches"],
                       "video": r["video"]["launches"]} for r in ranks],
            "one_rank_nccl": {"correlation_fwd": nccl[2][0],
                              "correlation_bwd": nccl[2][1],
                              "video_correlation_fwd": nccl_video_k1},
            "eval_cli": [c["launches"] for c in children]}}


# ------------------------------------------------------------ phase 15

# JPEG on the card machine, which has no encoder: the committed fixtures
# (tests/goldens/jpeg/, written by tests/make_jpeg_fixtures.py with PIL and
# OpenCV, each file's pixel digests in its manifest.json)
JPEG_DIR = os.path.join(GOLD, "jpeg")
# the serving rate: this many requests a route (raw, then JSON-JPEG) from
# SERVE_CLIENTS clients
JPEG_REQUESTS = 64
# the pseudo regime's frames: 9 make 8 pairs, 2 steps at batch 4
JPEG_TRAIN_FRAMES = 9
# the video CLI's frames: 9 make 8 pairs, 2 windows at VIDEO_B
JPEG_VIDEO_FRAMES = 9
# host decode timing: frames a thread
JPEG_TIMED = 16


def pixel_digest(img) -> str:
    import hashlib
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def decode_ms(fn, blob, threads: int) -> float:
    """Host ms a frame of ``fn(blob)`` on ``threads`` threads at once, each
    decoding JPEG_TIMED frames after one untimed call (wall time over all
    the frames)."""
    import threading
    barrier = threading.Barrier(threads + 1)

    def work():
        fn(blob)                    # warm: first-call costs stay outside
        barrier.wait()
        for _ in range(JPEG_TIMED):
            fn(blob)

    pool = [threading.Thread(target=work) for _ in range(threads)]
    for t in pool:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in pool:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in pool), "a decode thread hung"
    return (time.perf_counter() - t0) / (threads * JPEG_TIMED) * 1e3


def phase_jpeg(sd, tmp, corr_fwd, corr_bwd, card: str):
    """JPEG through the port's entry points on the card machine: (a) the
    fixtures decode to their digests, (b) the single-pair CLI, (c) the
    serving CLI's JSON route, (d) the pseudo training regime over a JPEG
    frame directory, (e) the video CLI over one, (f) the host decode cost.
    Returns its results, each path's K1 (and B1) launches among them."""
    import base64
    import http.client
    import shutil
    import signal
    import threading
    import numpy as np
    import torch
    from opticalflow_tpu_torch.cli import script_pwc
    from opticalflow_tpu_torch.engine import FlowEngine
    from opticalflow_tpu_torch.io.flo import read_flo
    from opticalflow_tpu_torch.io.images import (decode_png, encode_png,
                                                 load_image)
    from opticalflow_tpu_torch.models.pwcnet import PWCDCNet
    from opticalflow_tpu_torch.runtime.jpeg import decode_jpeg
    from opticalflow_tpu_torch.serve import decode_image

    t_phase = time.perf_counter()
    launches = {}
    # (a) every fixture, through load_image (PIL's pixels) and the server's
    # decode_image (OpenCV's: EXIF orientation applied)
    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    t0 = time.perf_counter()
    for name, want in sorted(manifest["files"].items()):
        path = os.path.join(JPEG_DIR, name)
        img = load_image(path)
        assert list(img.shape) == want["shape"], (name, img.shape)
        assert pixel_digest(img) == want["sha256_pil"], name
        with open(path, "rb") as f:
            served = decode_image(f.read(), name)
        assert list(served.shape) == want["cv2_shape"], (name, served.shape)
        assert pixel_digest(served) == want["sha256_cv2"], name
    present = [m for m in ("PIL", "imageio", "cv2") if m in sys.modules]
    assert not present, f"a third-party decoder was imported: {present}"
    import importlib.util
    installed = {m: importlib.util.find_spec(m) is not None
                 for m in ("PIL", "imageio", "cv2")}
    log(f"[15] (a) {len(manifest['files'])} JPEG fixtures (written by PIL "
        f"{manifest['pil']}, libjpeg-turbo {manifest['pil_libjpeg_turbo']}, "
        f"OpenCV {manifest['cv2']}) decoded to their digests through "
        f"load_image and decode_image (EXIF 6 and 8 rotated) in "
        f"{time.perf_counter() - t0:.2f} s, the decoder's g++ build "
        f"included; PIL, imageio, cv2 not imported (installed here: "
        f"{installed})")

    # (b) the single-pair CLI on the 436x1024 JPEG pair, resize and pad,
    # against the engine on the decoded arrays in this process, with
    # cuDNN's deterministic algorithms on for both (with its default
    # choice the CLI's model and this engine, the same weights twice,
    # differed by 1.25e-08 mean EPE)
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    jp1, jp2 = (os.path.join(JPEG_DIR, f"sintel_im{i}.jpg") for i in (1, 2))
    im1, im2 = load_image(jp1), load_image(jp2)
    assert im1.shape == im2.shape == (FULL_H, FULL_W, 3)
    engine = FlowEngine(PWCDCNet(), sd, flow_scale=20.0, device="cuda")
    launches["cli"] = 0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for mode in ("resize", "pad"):
        out = os.path.join(tmp, f"jpeg_{mode}.flo")
        k0 = corr_fwd.launches
        rc = script_pwc.main([jp1, jp2, out, "--ckpt", ckpt, "--size-mode",
                              mode, "--device", "cuda"])
        assert rc == 0, rc
        launched = corr_fwd.launches - k0
        assert launched == 5, (mode, launched)
        launches["cli"] += launched
        flow = read_flo(out)
        want = engine.flow_from_pair(im1, im2, preset="bgr_unit",
                                     size_mode=mode)
        assert flow.shape == (FULL_H, FULL_W, 2) and np.isfinite(flow).all()
        assert np.array_equal(flow, want), \
            f"CLI {mode}: EPE {epe(flow, want)!r} against the engine"
        log(f"[15] (b) cli/script_pwc on sintel_im1/2.jpg ({FULL_H}x{FULL_W}"
            f" 4:2:0 q90), --size-mode {mode}: {launched} K1 launches, the "
            f".flo equal bit for bit to FlowEngine.flow_from_pair on the "
            f"decoded arrays (mean |flow| {np.abs(flow).mean()!r})")
    torch.backends.cudnn.deterministic = deterministic

    # (c) the serving CLI (its defaults) on JSON requests of the JPEG pair
    with open(jp1, "rb") as f1, open(jp2, "rb") as f2:
        blobs = (f1.read(), f2.read())
    json_body = json.dumps({k: base64.b64encode(b).decode() for k, b in
                            zip(("im1", "im2"), blobs)}).encode()
    jhead = {"Content-Type": "application/json"}
    pixels = [decode_image(b) for b in blobs]
    raw_body = pixels[0].tobytes() + pixels[1].tobytes()
    raw = {"Content-Type": "application/octet-stream",
           "X-Frame-Shape": f"{FULL_H}x{FULL_W}x3", "X-Timeout": "120"}
    proc, port, lines, reader = start_serving_cli(
        ["--ckpt", ckpt, "--port", "0", "--warmup", f"{FULL_H}x{FULL_W}",
         "--device", "cuda"])
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        one_json = post(conn, json_body, jhead)
        one_raw = post(conn, raw_body, raw)
        conn.close()
        rates = {}
        for route, body, head in (("raw", raw_body, raw),
                                  ("json_jpeg", json_body, jhead)):
            res, wall = burst(port, [(i, body) for i in range(JPEG_REQUESTS)],
                              head, SERVE_CLIENTS)
            assert all(r[1] == 200 for r in res), route
            rates[route] = {"requests_per_s": JPEG_REQUESTS / wall,
                            "latency_ms": percentiles([r[3] for r in res])}
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    reader.join(timeout=60)
    child = [json.loads(ln.split(" ", 1)[1]) for ln in lines
             if ln.startswith("SERVE_CHILD ")]
    assert rc == 0 and child, (rc, "".join(lines[-40:]))
    child = child[0]
    assert one_json[0] == one_raw[0] == 200, (one_json[:2], one_raw[:2])
    assert one_json[1] == one_raw[1], "JSON-JPEG and raw flows differ"
    f = flo_array(one_json[1], FULL_H, FULL_W)
    assert np.isfinite(f).all()
    final = child["metrics"]
    assert final["errors"] == 0 and final["requests"] == \
        2 + 2 * JPEG_REQUESTS, final
    warm = len(child["buckets"]) * 2
    assert child["launches"] == 5 * (final["batches"] + warm), child
    launches["serve"] = child["launches"]
    log(f"[15] (c) cli/serve: a JSON request of the base64 JPEG pair "
        f"answered 200 with the raw route's bytes for the decoded pixels; "
        f"{JPEG_REQUESTS} requests from {SERVE_CLIENTS} clients: raw "
        f"{rates['raw']['requests_per_s']!r} requests/s (p50 "
        f"{rates['raw']['latency_ms']['p50']:.1f} ms), JSON-JPEG "
        f"{rates['json_jpeg']['requests_per_s']!r} (p50 "
        f"{rates['json_jpeg']['latency_ms']['p50']:.1f} ms); K1 "
        f"{child['launches']} launches in the CLI = 5 x ({final['batches']} "
        f"batches + {warm} warm-up forwards); {card}")

    # (d) the pseudo regime over a directory of JPEG frames (the pair,
    # alternating), resized to 384x512 by the loader
    froot = os.path.join(tmp, "jpeg_frames")
    os.makedirs(froot)
    for i in range(JPEG_TRAIN_FRAMES):
        shutil.copy(jp1 if i % 2 == 0 else jp2,
                    os.path.join(froot, f"{i:06d}.jpg"))
    out_dir = os.path.join(tmp, "jpeg_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", froot, "--pretrained", ckpt,
        "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (JPEG_TRAIN_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert [r["step"] for r in recs] == list(range(1, steps + 1)), recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[15] (d) cli/train --regime pseudo over {JPEG_TRAIN_FRAMES} JPEG "
        f"frames (436x1024 -> 384x512), {steps} steps at batch {TRAIN_B}: "
        f"losses {[r['loss'] for r in recs]}; K1/B1 launches "
        f"{launches['pseudo']} (5 and 5 a step); {wall_t:.2f} s wall")

    # (e) the video CLI over a directory of 1080x1920 JPEG frames (one
    # frame repeated): the levels of 1088x1920, K2's domain
    vroot = os.path.join(tmp, "jpeg_video")
    os.makedirs(vroot)
    for i in range(JPEG_VIDEO_FRAMES):
        shutil.copy(os.path.join(JPEG_DIR, "frame_1080p.jpg"),
                    os.path.join(vroot, f"{i:06d}.jpg"))
    k0 = corr_fwd.launches
    row = video_cli([vroot, os.path.join(tmp, "jpeg_video.y4m"), "--ckpt",
                     ckpt, "--mode", "arrows", "--batch", str(VIDEO_B),
                     "--device", "cuda"], JPEG_VIDEO_FRAMES, HD_H, HD_W)
    launches["video"] = corr_fwd.launches - k0
    windows = row.pop("windows")
    assert windows == -(-(JPEG_VIDEO_FRAMES - 1) // VIDEO_B), windows
    assert launches["video"] == 5 * windows, (launches, windows)
    del row["runner"], row["bytes_uploaded"]
    log(f"[15] (e) cli/extract_video --mode arrows over {JPEG_VIDEO_FRAMES} "
        f"JPEG frames of {HD_H}x{HD_W}: {windows} windows, "
        f"{launches['video']} K1 launches; decode {row['decode_ms']:.2f} ms "
        f"a frame on the decode thread ({row['decode_share']:.1%} of the "
        f"run), {row['fps']:.2f} fps over the run")
    assert "cv2" not in sys.modules, "the port imported OpenCV"

    # (f) the host's cost to decode a frame: decode_jpeg on 1 and 4 threads
    # (the C call releases the GIL; each call also takes a fresh output
    # array from the allocator), the C call alone into a buffer each thread
    # keeps, and the port's PNG decoder on the same pixels
    import ctypes
    from opticalflow_tpu_torch.runtime import jpeg as jpeg_lib
    lib = jpeg_lib.load()
    host = {}
    for what, name in (("436x1024", "sintel_im1.jpg"),
                       ("1080x1920", "frame_1080p.jpg")):
        with open(os.path.join(JPEG_DIR, name), "rb") as f:
            blob = f.read()
        pixels = decode_jpeg(blob, orient=False)
        png = encode_png(pixels)
        kept = {}

        def c_call(b, shape=pixels.shape):
            ident = threading.get_ident()
            if ident not in kept:
                kept[ident] = (np.empty(shape, np.uint8),
                               ctypes.create_string_buffer(512))
            out, msg = kept[ident]
            rc = lib.ojpeg_decode(b, len(b), out.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)), shape[0], shape[1], msg, 512)
            assert rc == 0, msg.value

        row_h = {"jpeg_bytes": len(blob), "png_bytes": len(png)}
        for threads in (1, 4):
            row_h[f"jpeg_ms_{threads}_thread"] = decode_ms(
                lambda b: decode_jpeg(b, orient=False), blob, threads)
            row_h[f"c_call_ms_{threads}_thread"] = decode_ms(c_call, blob,
                                                             threads)
        row_h["png_ms_1_thread"] = decode_ms(decode_png, png, 1)
        host[what] = row_h
        log(f"[15] (f) host decode of one {what} frame ({len(blob)} bytes of "
            f"JPEG): decode_jpeg {row_h['jpeg_ms_1_thread']:.2f} ms on 1 "
            f"thread, {row_h['jpeg_ms_4_thread']:.2f} ms a frame on 4 "
            f"threads at once; the C call alone "
            f"{row_h['c_call_ms_1_thread']:.2f} / "
            f"{row_h['c_call_ms_4_thread']:.2f} ms; decode_png of the same "
            f"pixels ({len(png)} bytes) {row_h['png_ms_1_thread']:.2f} ms; "
            f"{card}")
    phase_s = time.perf_counter() - t_phase
    log(f"[15] phase 15 took {phase_s:.1f} s; {card}")
    return {"fixtures": len(manifest["files"]), "installed": installed,
            "serve": rates,
            "pseudo_losses": [r["loss"] for r in recs],
            "video": row, "host_decode": host, "launches": launches,
            "phase_s": phase_s, "card": card}


# ------------------------------------------------------------ phase 16

# compare mode: the network's arrows beside a classical baseline's, on a
# moving 720x1280 clip at B=4 (15 pairs: 4 windows, the last partial)
COMPARE_FRAMES = 16
COMPARE_METHODS = ("farneback", "dis", "lucaskanade_dense")
FARNEBACK_REPS = 5


def phase_compare(sd, tmp, corr_fwd, card: str):
    """``cli/extract_video --mode compare`` on the card: (a)-(c) of the
    docstring's phase 16.  Returns its results."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.io.video import read_frames
    from opticalflow_tpu_torch.io.yuv import bgr_to_gray
    from opticalflow_tpu_torch.runtime import dis
    from opticalflow_tpu_torch.viz import farneback as fb
    from opticalflow_tpu_torch.viz import overlay as ov

    t_phase = time.perf_counter()
    dis.load()          # g++ at first use: built here, outside the runs
    build_s = time.perf_counter() - t_phase
    log(f"[16] runtime/dis.cpp built by g++ and loaded in {build_s:.1f} s")
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    clip = os.path.join(tmp, "compare720.y4m")
    write_clip(clip, moving_frames(np.random.RandomState(16), COMPARE_FRAMES,
                                   VIDEO_H, VIDEO_W))
    results = {"dis_build_s": build_s, "farneback_card_vs_cpu": {},
               "modes": {}}

    # (b) Farneback on the card against the same function on the CPU
    f1, f2 = list(read_frames(clip, max_frames=2))
    g1, g2 = bgr_to_gray(f1), bgr_to_gray(f2)
    keys = ("pyr_scale", "levels", "winsize", "iterations", "poly_n",
            "poly_sigma")
    for method in ("farneback", "lucaskanade_dense"):
        params = dict(zip(keys, fb.FARNEBACK_PARAMS[method]))
        on_card = fb.farneback_flow(g1, g2, device="cuda", **params)
        card_ms = []
        for _ in range(FARNEBACK_REPS):       # the first call warmed up
            t0 = time.perf_counter()
            fb.farneback_flow(g1, g2, device="cuda", **params)
            card_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        on_cpu = fb.farneback_flow(g1, g2, device="cpu", **params)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        err = epe(on_card, on_cpu)
        e = np.hypot(*(on_card - on_cpu).transpose(2, 0, 1))
        results["farneback_card_vs_cpu"][method] = {
            "epe_mean": err, "epe_p99": float(np.percentile(e, 99)),
            "epe_max": float(e.max()), "card_ms": card_ms,
            "cpu_ms": cpu_ms, "mean_flow_px": float(np.abs(on_cpu).mean())}
        log(f"[16] (b) {method} on one {VIDEO_H}x{VIDEO_W} pair, the card "
            f"against the CPU: mean EPE {err!r} (bound 1e-4), p99 "
            f"{float(np.percentile(e, 99))!r}, max {float(e.max())!r}; mean "
            f"|flow| {float(np.abs(on_cpu).mean()):.4f} px; ms a pair on the "
            f"card {[round(v, 2) for v in card_ms]} (host clock, the "
            f"readback included), on the host's CPU {cpu_ms:.1f} [{card}]")
        assert on_card.shape == (VIDEO_H, VIDEO_W, 2)
        assert np.isfinite(on_card).all() and err <= 1e-4, err

    # (a) the CLI for each method, the baseline's time a pair instrumented
    real = ov.opencv_flow
    base_ms = []

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = real(*a, **k)
        base_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    windows_want = -(-(COMPARE_FRAMES - 1) // VIDEO_B)
    ov.opencv_flow = timed
    try:
        for method in COMPARE_METHODS:
            base_ms.clear()
            before = corr_fwd.launches
            row = video_cli([clip, os.path.join(tmp, f"cmp_{method}.y4m"),
                             "--ckpt", ckpt, "--mode", "compare",
                             "--compare-method", method, "--batch",
                             str(VIDEO_B), "--device", "cuda"],
                            COMPARE_FRAMES, VIDEO_H, VIDEO_W)
            row["k1_launches"] = launched = corr_fwd.launches - before
            assert row["windows"] == windows_want, row["windows"]
            assert launched == 5 * windows_want, launched
            assert len(base_ms) == COMPARE_FRAMES - 1, len(base_ms)
            row["baseline_ms"] = list(base_ms)
            row["baseline_ms_median"] = float(np.median(base_ms))
            row["baseline_on"] = "host" if method == "dis" else "card"
            del row["runner"], row["bytes_uploaded"]
            results["modes"][method] = row
            log(f"[16] (a) extract_video --mode compare --compare-method "
                f"{method}, {COMPARE_FRAMES} frames {VIDEO_H}x{VIDEO_W} "
                f"B={VIDEO_B} bf16: {row['fps']!r} fps over the whole run "
                f"({row['run_s']!r} s); the baseline {row['baseline_on']}'s "
                f"ms a pair median {row['baseline_ms_median']:.2f} (first "
                f"{base_ms[0]:.2f}); draw (baseline included) "
                f"{row['draw_ms']:.2f} ms a frame ({row['draw_share']:.0%} "
                f"of the run); {row['windows']} windows, K1 {launched} "
                f"launches; output {VIDEO_H}x{2 * VIDEO_W} [{card}]")
    finally:
        ov.opencv_flow = real

    # (c) none of the libraries the JAX package draws and reads with
    loaded = [m for m in ("cv2", "PIL", "imageio") if m in sys.modules]
    log(f"[16] (c) cv2, PIL, imageio in sys.modules: {loaded or 'none'}")
    assert not loaded, loaded
    results["phase_s"] = phase_s = time.perf_counter() - t_phase
    results["card"] = card
    log(f"[16] phase 16 took {phase_s:.1f} s; {card}")
    return results


# ------------------------------------------------------------ phase 17

# MPEG-4 Part 2 video on the card machine, which has neither OpenCV nor
# FFmpeg: the committed fixtures (tests/goldens/video/, written by
# tests/make_video_fixtures.py with OpenCV's FFmpeg, every frame's digest
# in its manifest.json), the port's writer at 720p and 1080p, the video CLI
# from .mp4 to .mp4, capture_frame and the pseudo regime on an .mp4
MP4_DIR = os.path.join(GOLD, "video")
MP4_FRAMES = 48          # four GOPs of 12
MP4_HD_RUN = 16          # frames of the 1080p CLI run (K2's levels)
MP4_TRAIN_FRAMES = 9     # 8 pairs: 2 pseudo steps at batch 4
MP4_CAPTURE = 30         # a frame of the third GOP
MP4_CONVERT_FRAMES = 8   # frames of the BGR->I420 timing


def psnr(decoded, frames) -> float:
    import numpy as np
    mse = np.mean([(d.astype(np.float64) - f) ** 2
                   for d, f in zip(decoded, frames)])
    return float(10 * np.log10(255.0 ** 2 / mse))


HOST_TIMED = 4           # passes over each clip for the host decode times


def video_manifest() -> dict:
    with open(os.path.join(MP4_DIR, "manifest.json")) as f:
        return json.load(f)


def fixtures_of(manifest: dict, *groups: str) -> dict:
    """The manifest's entries for the files that the named fixture
    functions of tests/make_video_fixtures.py wrote (each entry's
    ``group``: the function's name without ``_fixtures``)."""
    return {n: w for n, w in manifest["files"].items() if w["group"] in groups}


def check_fixtures(fixtures: dict, seek_refused=()) -> dict:
    """Every fixture read through the port as cv2.VideoCapture reads it:
    its frames' digests, its fps/size/count, and each recorded seek's
    frame (a frame the sequential read never shows by the manifest's
    ``seek_sha256``), or a ValueError where cv2's seek reads nothing
    (Unsupported for the files in ``seek_refused``: FFmpeg's generic index
    seek).  A fixture
    the manifest records as refused raises Unsupported.  Returns the counts
    of frames, seeks and seeks reading nothing, and the refused names."""
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.runtime.mpeg4 import Unsupported
    frames = seeks = none = 0
    refused = []
    for name, want in sorted(fixtures.items()):
        path = os.path.join(MP4_DIR, name)
        if "port_refuses" in want:
            try:
                list(vio.read_frames(path))
            except Unsupported:
                refused.append(name)
                continue
            raise AssertionError(f"{name} was read")
        got = list(vio.read_frames(path))
        frames += len(got)
        assert [pixel_digest(fr) for fr in got] == want["sha256"], name
        assert vio.video_info(path) == {k: want[k] for k in (
            "fps", "width", "height", "frames")}, name
        video = None if "seeks" not in want else (
            vio.ImageSequence(path) if vio.is_sequence(path) else
            vio.EncodedVideo(path))
        for t, hit in want.get("seeks", {}).items():
            seeks += 1
            if hit is None or name in seek_refused:
                none += 1
                try:
                    video.frame(int(t))
                except (Unsupported if name in seek_refused else ValueError):
                    continue
                raise AssertionError(f"{name}: seek {t} read a frame")
            digest = (want["seek_sha256"][t] if hit == -1 else
                      want["sha256"][hit])
            assert pixel_digest(video.frame(int(t))) == digest, (name, t)
    return {"frames": frames, "seeks": seeks, "seeks_none": none,
            "refused": refused}


def host_decode(make, samples) -> tuple:
    """Host ms a frame to decode ``samples`` on one thread, with a fresh
    decoder from ``make`` on each of HOST_TIMED passes after one untimed
    call (the library is loaded), and the last pass's pictures (MPEG-1/2's
    decoder hands them over in lists, a packet late, the last at its
    flush)."""
    from opticalflow_tpu_torch.runtime import mpeg12
    make().decode(samples[0])
    t0 = time.perf_counter()
    for _ in range(HOST_TIMED):
        d = make()
        got = [d.decode(s) for s in samples]
        if isinstance(d, mpeg12.Decoder):
            got = [q for p in got for q in p] + d.flush()
    ms = (time.perf_counter() - t0) / HOST_TIMED / len(samples) * 1e3
    assert len(got) == len(samples), (len(got), len(samples))
    return ms, got


def convert_ms(planes, size=None) -> float:
    """Host ms a picture for swscale's conversion of ``planes`` to BGR
    (at ``size``: scaled), HOST_TIMED passes."""
    from opticalflow_tpu_torch.runtime.mpeg4 import i420_to_bgr
    t0 = time.perf_counter()
    for _ in range(HOST_TIMED):
        for p in planes:
            i420_to_bgr(*p, size=size)
    return (time.perf_counter() - t0) / HOST_TIMED / len(planes) * 1e3


def phase_mp4(sd, tmp, corr_fwd, corr_bwd, card: str):
    """MPEG-4 Part 2 through the port's entry points on the card machine:
    (a) the fixtures decode to their digests, (b) the writer and reader at
    720p and 1080p, (c) the video CLI from .mp4 to .mp4 and from .y4m to
    .y4m, (d) capture_frame, (e) the pseudo regime.  Returns its results,
    each path's K1 (and B1) launches among them."""
    import contextlib
    import io
    import numpy as np
    import torch
    from opticalflow_tpu_torch.cli import capture_frame
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.io.images import decode_png
    from opticalflow_tpu_torch.runtime import mpeg4

    from opticalflow_tpu_torch.io.yuv import rgb_to_i420

    t_phase = time.perf_counter()
    launches = {}

    # (a) every fixture: its frames' digests and cv2's CAP_PROP_* values
    manifest = video_manifest()
    t0 = time.perf_counter()
    mpeg4_fixtures = fixtures_of(manifest, "mpeg4")
    n_frames = check_fixtures(mpeg4_fixtures)["frames"]
    present = [m for m in ("cv2", "PIL") if m in sys.modules]
    assert not present, f"the port imported {present}"
    log(f"[17] (a) {len(mpeg4_fixtures)} video fixtures (written by "
        f"OpenCV {manifest['opencv']}, FFmpeg {manifest['ffmpeg']}; "
        f"mp4v/XVID/FMP4, 52x36 cropped, a still, raw I420 at full range, "
        f"packets/4MV/rounding/dquant/MPEG quantisation) decoded to their "
        f"{n_frames} frame digests and cv2's fps/size/count in "
        f"{time.perf_counter() - t0:.2f} s (the Motion JPEG ones: phase "
        f"18); cv2, PIL not imported; {card}")

    # (b) the writer and reader at 720p and 1080p: every frame read back
    # equals the encoder's reconstruction
    rng = np.random.RandomState(17)
    codec, clips = {}, {}
    for tag, h, w in (("720p", VIDEO_H, VIDEO_W), ("1080p", HD_H, HD_W)):
        frames = moving_frames(rng, MP4_FRAMES, h, w)
        path = os.path.join(tmp, f"clip_{tag}.mp4")
        wr = vio.Mpeg4Writer(path, 30.0, (w, h), keep_recon=True)
        t0 = time.perf_counter()
        for fr in frames:
            wr.write(fr)
        wr.release()
        enc_ms = (time.perf_counter() - t0) / MP4_FRAMES * 1e3
        t0 = time.perf_counter()
        decoded = list(vio.read_frames(path))
        dec_ms = (time.perf_counter() - t0) / MP4_FRAMES * 1e3
        assert len(decoded) == MP4_FRAMES, len(decoded)
        for k, (d, r) in enumerate(zip(decoded, wr.recon)):
            assert np.array_equal(d, mpeg4.i420_to_bgr(*r)), (tag, k)
        row = {"bytes": os.path.getsize(path), "psnr_db": psnr(decoded,
                                                               frames),
               "encode_ms": enc_ms, "decode_ms": dec_ms,
               "keyframes": vio.EncodedVideo(path).keyframes}
        assert row["keyframes"] == [0, 12, 24, 36], row["keyframes"]
        # BGR -> I420: the C conversion the writers use against its numpy
        # reference, on the same frames, one thread
        ms = {}
        for name, fn in (("c", mpeg4.to_i420), ("numpy", lambda f: rgb_to_i420(
                np.ascontiguousarray(f[..., ::-1])))):
            t0 = time.perf_counter()
            packed = [fn(fr) for fr in frames[:MP4_CONVERT_FRAMES]]
            ms[name] = ((time.perf_counter() - t0) / MP4_CONVERT_FRAMES
                        * 1e3)
            if name == "c":
                ref = packed
        assert all(np.array_equal(a, b) for a, b in zip(ref, packed))
        row["to_i420_ms"], row["rgb_to_i420_ms"] = ms["c"], ms["numpy"]
        log(f"[17] (b) BGR->I420 {h}x{w}: runtime/mpeg4.to_i420 (C) "
            f"{ms['c']:.2f} ms a frame, io/yuv.rgb_to_i420 (numpy) "
            f"{ms['numpy']:.2f}, equal on {MP4_CONVERT_FRAMES} frames; "
            f"{card}")
        codec[tag] = row
        clips[tag] = (path, frames, decoded)
        log(f"[17] (b) {MP4_FRAMES} moving frames {h}x{w} -> .mp4 by the "
            f"port's writer: {row['bytes']} bytes "
            f"({row['bytes'] / MP4_FRAMES:.0f} a frame), PSNR "
            f"{row['psnr_db']!r} dB against the source, host "
            f"{enc_ms:.2f} ms a frame to encode (BGR->I420, VOP, mux) and "
            f"{dec_ms:.2f} to decode (demux, VOP, I420->BGR), one thread; "
            f"every frame read back equals the encoder's reconstruction; "
            f"I-VOPs at {row['keyframes']}; {card}")

    # (c) the video CLI: the 720p .mp4 to .mp4, the same frames as .y4m to
    # .y4m, and one run at 1080p (K2's levels)
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    y4m = os.path.join(tmp, "clip_720p.y4m")
    write_clip(y4m, clips["720p"][2])
    cli_rows = {}
    for tag, src, out, n, h, w, extra in (
            ("mp4", clips["720p"][0], "out_720p.mp4", MP4_FRAMES, VIDEO_H,
             VIDEO_W, ()),
            ("y4m", y4m, "out_720p.y4m", MP4_FRAMES, VIDEO_H, VIDEO_W, ()),
            ("mp4_1080p", clips["1080p"][0], "out_1080p.mp4", MP4_HD_RUN,
             HD_H, HD_W, ("--max-frames", str(MP4_HD_RUN)))):
        k0 = corr_fwd.launches
        row = video_cli([src, os.path.join(tmp, out), "--ckpt", ckpt,
                         "--mode", "arrows", "--batch", str(VIDEO_B),
                         "--dtype", "bfloat16", "--device", "cuda", *extra],
                        n, h, w)
        row["k1_launches"] = launched = corr_fwd.launches - k0
        windows = row.pop("windows")
        assert windows == -(-(n - 1) // VIDEO_B), windows
        assert launched == 5 * windows, (launched, windows)
        del row["runner"], row["bytes_uploaded"]
        cli_rows[tag] = row
        log(f"[17] (c) extract_video --mode arrows B={VIDEO_B} bf16, "
            f"{tag} ({n} frames {h}x{w}): {row['fps']!r} fps over the run "
            f"({row['run_s']!r} s, fill {row['fill_s']:.2f} s); decode "
            f"thread busy {row['decode_share']:.1%} ({row['decode_ms']:.2f} "
            f"ms a frame), encode thread {row['encode_share']:.1%} "
            f"({row['encode_ms']:.2f} ms a frame), draw "
            f"{row['draw_share']:.1%}, wait {row['wait_share']:.1%}; "
            f"{windows} windows, K1 {launched} launches; {card}")
    launches["cli"] = sum(r["k1_launches"] for r in cli_rows.values())

    # (d) capture_frame at a frame of the third GOP
    png = os.path.join(tmp, "frame30.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([clips["720p"][0], str(MP4_CAPTURE),
                                   png]) == 0
    with open(png, "rb") as f:
        got = decode_png(f.read())[..., ::-1]
    assert np.array_equal(got, clips["720p"][2][MP4_CAPTURE])
    log(f"[17] (d) capture_frame at frame {MP4_CAPTURE} (I-VOP 24, then 6 "
        f"P-VOPs) equals read_frames' frame {MP4_CAPTURE}")

    # (e) the pseudo regime over an .mp4 of the first frames (384x512)
    train_mp4 = os.path.join(tmp, "train.mp4")
    wr = vio.Mpeg4Writer(train_mp4, 30.0, (VIDEO_W, VIDEO_H))
    for fr in clips["720p"][1][:MP4_TRAIN_FRAMES]:
        wr.write(fr)
    wr.release()
    out_dir = os.path.join(tmp, "mp4_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", train_mp4, "--pretrained", ckpt,
        "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (MP4_TRAIN_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert [r["step"] for r in recs] == list(range(1, steps + 1)), recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[17] (e) cli/train --regime pseudo over an .mp4 of "
        f"{MP4_TRAIN_FRAMES} frames ({VIDEO_H}x{VIDEO_W} -> 384x512), "
        f"{steps} steps at batch {TRAIN_B}: losses "
        f"{[r['loss'] for r in recs]}; K1/B1 launches {launches['pseudo']} "
        f"(5 and 5 a step); {wall_t:.2f} s wall; {card}")
    # (the training CLI draws its loss curve with matplotlib where it is
    # installed, which imports PIL; the card machine has neither)
    assert "cv2" not in sys.modules, "the port imported OpenCV"
    phase_s = time.perf_counter() - t_phase
    log(f"[17] phase 17 took {phase_s:.1f} s; {card}")
    return {"fixtures": len(mpeg4_fixtures), "codec": codec,
            "cli": cli_rows, "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


# ------------------------------------------------------------ phase 18

# Motion JPEG and image sequences on the card machine, read as
# cv2.VideoCapture reads them (FFmpeg's JPEG decode and swscale, in the
# port's host C++): the committed fixtures' cv2 digests, then sources
# built from the committed JPEG files' bytes (no encoder there): the
# 436x1024 pair alternating, as a %06d.jpg sequence and muxed into an
# MJPEG AVI by the port's RIFF muxer, and a 1080p frame repeated
SEQ_FRAMES = 48          # the 436x1024 sources
SEQ_HD_FRAMES = 16       # the 1080p AVI (K2's levels)
SEQ_TRAIN_FRAMES = 9     # 8 pairs: 2 pseudo steps at batch 4
SEQ_CAPTURE = 23         # a middle frame of the AVI
SEQ_TIMED_THREADS = 1


def phase_mjpeg(sd, tmp, corr_fwd, corr_bwd, card: str):
    """Motion JPEG and image sequences through the port's entry points on
    the card machine: (a) the fixtures decode to cv2.VideoCapture's
    digests, (b) the sources, (c) the video CLI over each beside a .y4m of
    the same frames, (d) capture_frame, (e) the pseudo regime over a
    pattern, (f) host decode ms, FFmpeg flavour beside libjpeg's, (g) no
    cv2, PIL or jax imported.  Returns its results, each path's K1 (and
    B1) launches among them."""
    import contextlib
    import io
    import numpy as np
    import torch
    from opticalflow_tpu_torch.cli import capture_frame
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.io.avi import AviWriter
    from opticalflow_tpu_torch.io.images import decode_png
    from opticalflow_tpu_torch.runtime.jpeg import (decode_jpeg,
                                                    decode_jpeg_ffmpeg)

    t_phase = time.perf_counter()
    launches = {}

    # (a) every JPEG fixture through the FFmpeg flavour, every Motion JPEG
    # fixture through io/video: cv2.VideoCapture's digests and CAP_PROP_*
    t0 = time.perf_counter()
    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        jpeg_manifest = json.load(f)
    for name, want in sorted(jpeg_manifest["files"].items()):
        with open(os.path.join(JPEG_DIR, name), "rb") as f:
            got = decode_jpeg_ffmpeg(f.read(), name)
        assert pixel_digest(got) == want["sha256_videocapture"], name
    vman = video_manifest()
    mjpeg = fixtures_of(vman, "mjpeg")
    n_frames = check_fixtures(mjpeg)["frames"]
    log(f"[18] (a) {len(jpeg_manifest['files'])} JPEG fixtures and "
        f"{len(mjpeg)} Motion JPEG ones ({n_frames} frames: cv2's MJPG in "
        f".avi and .mp4, DHT-less frames) decoded to cv2.VideoCapture's "
        f"digests (OpenCV {vman['opencv']}, FFmpeg "
        f"{vman['ffmpeg']}) and its fps/size/count in "
        f"{time.perf_counter() - t0:.2f} s; {card}")

    # (b) the sources: the committed JPEG bytes, never re-encoded
    jp = []
    for name in ("sintel_im1.jpg", "sintel_im2.jpg", "frame_1080p.jpg"):
        with open(os.path.join(JPEG_DIR, name), "rb") as f:
            jp.append(f.read())
    seq_dir, train_dir = (os.path.join(tmp, d) for d in ("seq", "train"))
    os.makedirs(seq_dir)
    os.makedirs(train_dir)
    pattern = os.path.join(seq_dir, "%06d.jpg")
    train_pattern = os.path.join(train_dir, "%06d.jpg")
    avi, hd_avi = (os.path.join(tmp, n) for n in ("seq.avi", "seq_hd.avi"))
    mux = AviWriter(avi, (FULL_W, FULL_H), (25, 1), fourcc="MJPG")
    for i in range(SEQ_FRAMES):
        with open(vio.frame_filename(pattern, i), "wb") as f:
            f.write(jp[i % 2])
        if i < SEQ_TRAIN_FRAMES:
            with open(vio.frame_filename(train_pattern, i), "wb") as f:
                f.write(jp[i % 2])
        mux.write(jp[i % 2], True)
    mux.release()
    mux = AviWriter(hd_avi, (HD_W, HD_H), (25, 1), fourcc="MJPG")
    for _ in range(SEQ_HD_FRAMES):
        mux.write(jp[2], True)
    mux.release()
    pair = [decode_jpeg_ffmpeg(b) for b in jp[:2]]
    y4m = os.path.join(tmp, "seq.y4m")
    write_clip(y4m, [pair[i % 2] for i in range(SEQ_FRAMES)])
    for src, n, h, w in ((pattern, SEQ_FRAMES, FULL_H, FULL_W),
                         (avi, SEQ_FRAMES, FULL_H, FULL_W),
                         (hd_avi, SEQ_HD_FRAMES, HD_H, HD_W)):
        assert vio.video_info(src) == {"fps": 25.0, "width": w, "height": h,
                                       "frames": n}, src
    assert all(np.array_equal(a, b) for a, b in
               zip(vio.read_frames(avi, max_frames=2), pair))

    # (c) the video CLI over each source, and over the .y4m of the same
    # frames (no JPEG decode), in this call
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    cli_rows = {}
    for tag, src, n, h, w in (
            ("pattern", pattern, SEQ_FRAMES, FULL_H, FULL_W),
            ("avi", avi, SEQ_FRAMES, FULL_H, FULL_W),
            ("y4m", y4m, SEQ_FRAMES, FULL_H, FULL_W),
            ("avi_1080p", hd_avi, SEQ_HD_FRAMES, HD_H, HD_W)):
        k0 = corr_fwd.launches
        row = video_cli([src, os.path.join(tmp, f"out_{tag}.y4m"), "--ckpt",
                         ckpt, "--mode", "arrows", "--batch", str(VIDEO_B),
                         "--dtype", "bfloat16", "--device", "cuda"], n, h, w)
        row["k1_launches"] = launched = corr_fwd.launches - k0
        windows = row.pop("windows")
        assert windows == -(-(n - 1) // VIDEO_B), windows
        assert launched == 5 * windows, (launched, windows)
        row["k1_a_window"] = launched / windows
        del row["runner"], row["bytes_uploaded"]
        cli_rows[tag] = row
        log(f"[18] (c) extract_video --mode arrows B={VIDEO_B} bf16, {tag} "
            f"({n} frames {h}x{w}): {row['fps']!r} fps over the run "
            f"({row['run_s']!r} s, fill {row['fill_s']:.2f} s); decode "
            f"thread busy {row['decode_ms']!r} ms a frame "
            f"({row['decode_share']:.1%}), draw {row['draw_share']:.1%}, "
            f"encode {row['encode_share']:.1%}; {windows} windows, K1 "
            f"{launched} launches (5 a window); {card}")
    launches["cli"] = sum(r["k1_launches"] for r in cli_rows.values())

    # (d) capture_frame at a middle frame of the AVI
    png = os.path.join(tmp, "frame_mid.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([avi, str(SEQ_CAPTURE), png]) == 0
    with open(png, "rb") as f:
        got = decode_png(f.read())[..., ::-1]
    assert np.array_equal(got, pair[SEQ_CAPTURE % 2])
    assert np.array_equal(got, vio.read_frame(avi, SEQ_CAPTURE))
    log(f"[18] (d) capture_frame at frame {SEQ_CAPTURE} of the MJPEG AVI "
        f"equals the FFmpeg flavour's decode of its JPEG")

    # (e) the pseudo regime over a %06d.jpg pattern (436x1024 -> 384x512)
    out_dir = os.path.join(tmp, "seq_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", train_pattern, "--pretrained",
        ckpt, "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (SEQ_TRAIN_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert [r["step"] for r in recs] == list(range(1, steps + 1)), recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[18] (e) cli/train --regime pseudo over a %06d.jpg pattern of "
        f"{SEQ_TRAIN_FRAMES} frames ({FULL_H}x{FULL_W} -> 384x512), {steps} "
        f"steps at batch {TRAIN_B}: losses {[r['loss'] for r in recs]}; "
        f"K1/B1 launches {launches['pseudo']} (5 and 5 a step); "
        f"{wall_t:.2f} s wall; {card}")

    # (f) host ms to decode a frame on one thread: the FFmpeg flavour
    # (decode and swscale's conversion to BGR) beside the libjpeg one
    host = {}
    for what, blob in (("436x1024", jp[0]), ("1080x1920", jp[2])):
        host[what] = row_h = {
            "ffmpeg_ms": decode_ms(decode_jpeg_ffmpeg, blob,
                                   SEQ_TIMED_THREADS),
            "libjpeg_ms": decode_ms(lambda b: decode_jpeg(b, orient=False),
                                    blob, SEQ_TIMED_THREADS)}
        log(f"[18] (f) host decode of one {what} JPEG frame on one thread: "
            f"FFmpeg flavour {row_h['ffmpeg_ms']!r} ms, libjpeg flavour "
            f"{row_h['libjpeg_ms']!r} ms; {card}")

    # (g) what the port imported
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"
    phase_s = time.perf_counter() - t_phase
    log(f"[18] (g) cv2, PIL, jax not imported; phase 18 took {phase_s:.1f} "
        f"s; {card}")
    return {"fixtures": len(jpeg_manifest["files"]) + len(mjpeg),
            "cli": cli_rows, "host_decode": host,
            "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


# ------------------------------------------------------------ phase 19

# VP8 and Matroska/WebM on the card machine, read as cv2.VideoCapture reads
# them (runtime/vp8.cpp: FFmpeg's vp8 decoder in host C++; io/mkv.py; the
# .y4m and odd-height conversions of swscale in runtime/ffmpeg_dsp.h): the
# committed fixtures' cv2 digests, then the committed 436x1024 VP8 WebM
# (the Sintel pair alternating, 13 frames, key frames at 0 and 12; no VP8
# encoder there) through the entry points
VP8_CLIP = "vp8_sintel_436x1024.webm"
VP8_FRAMES = 13
VP8_CAPTURE = 12         # the second key frame
VP8_TRAIN_FRAMES = 9     # 8 pairs: 2 pseudo steps at batch 4


def webm_head(src: str, dst: str, n: int, codec: bytes = b"V_VP8") -> None:
    """The first ``n`` frames of a VP8 (or ``codec``) WebM remuxed by
    io/mkv's element writers (one Cluster, SimpleBlocks, 40 ms apart)."""
    import struct
    from opticalflow_tpu_torch.io import mkv
    box = mkv.MkvFile(src)
    el, u = mkv._el, mkv._uint_el
    blocks = b""
    with open(src, "rb") as f:
        for i in range(n):
            key = 0x80 if i in box.keyframes else 0
            blocks += el(mkv.SIMPLE_BLOCK, b"\x81" + struct.pack(
                ">hB", 40 * i, key) + box.sample(f, i))
    track = el(mkv.TRACK_ENTRY, u(mkv.TRACK_NUMBER, 1) + u(mkv.TRACK_TYPE, 1)
               + el(mkv.CODEC_ID, codec)
               + u(mkv.DEFAULT_DURATION, 40_000_000)
               + el(mkv.VIDEO, u(mkv.PIXEL_WIDTH, box.width)
                    + u(mkv.PIXEL_HEIGHT, box.height)))
    info = el(mkv.INFO, u(mkv.TIMECODE_SCALE, 1_000_000)
              + el(mkv.DURATION, struct.pack(">d", 40.0 * n)))
    with open(dst, "wb") as f:
        f.write(el(mkv.EBML, el(mkv.DOCTYPE, b"webm")) + el(
            mkv.SEGMENT, info + el(mkv.TRACKS, track) + el(
                mkv.CLUSTER, u(mkv.TIMECODE, 0) + blocks)))


def phase_vp8(sd, tmp, corr_fwd, corr_bwd, card: str):
    """VP8 and Matroska/WebM through the port's entry points on the card
    machine: (a) the new video fixtures equal cv2's digests, (b) the video
    CLI over the 436x1024 WebM, over a .y4m of its frames and with .mkv
    out, (c) capture_frame, (d) the pseudo regime over a .webm, (e) host
    ms to decode a frame, VP8 beside MPEG-4 Part 2 on the same frames, (f)
    no cv2, PIL or jax imported.  Returns its results, each path's K1 (and
    B1) launches among them."""
    import contextlib
    import io
    import numpy as np
    import torch
    from opticalflow_tpu_torch.cli import capture_frame
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.io.images import decode_png
    from opticalflow_tpu_torch.io.mkv import MkvFile
    from opticalflow_tpu_torch.runtime import vp8
    from opticalflow_tpu_torch.runtime.mpeg4 import Decoder

    t_phase = time.perf_counter()
    launches = {}

    # (a) the fixtures of this slice: VP8 in WebM, Matroska and AVI (the
    # version-, size- and container-patched ones too), mp4v/MJPG/I420 in
    # Matroska, the odd-height MPEG-4 patches
    t0 = time.perf_counter()
    manifest = video_manifest()
    new = fixtures_of(manifest, "vp8")
    n_frames = check_fixtures(new)["frames"]
    log(f"[19] (a) {len(new)} fixtures (VP8 in .webm/.mkv/.avi, version-, "
        f"size- and container-patched; mp4v/MJPG/I420 in .mkv; odd-height "
        f"MPEG-4) decoded to cv2.VideoCapture's {n_frames} frame digests "
        f"(OpenCV {manifest['opencv']}, FFmpeg {manifest['ffmpeg']}) and "
        f"its fps/size/count in {time.perf_counter() - t0:.2f} s; {card}")

    # (b) the video CLI over the WebM, the same frames as a .y4m, and the
    # WebM again with .mkv out (MPEG-4 Part 2 in Matroska)
    webm = os.path.join(MP4_DIR, VP8_CLIP)
    frames = list(vio.read_frames(webm))
    assert len(frames) == VP8_FRAMES and frames[0].shape == (FULL_H, FULL_W,
                                                              3)
    y4m = os.path.join(tmp, "vp8.y4m")
    write_clip(y4m, frames)
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    cli_rows = {}
    for tag, src, out in (("webm", webm, "out_webm.y4m"),
                          ("y4m", y4m, "out_y4m.y4m"),
                          ("webm_to_mkv", webm, "out_webm.mkv")):
        k0 = corr_fwd.launches
        row = video_cli([src, os.path.join(tmp, out), "--ckpt", ckpt,
                         "--mode", "arrows", "--batch", str(VIDEO_B),
                         "--dtype", "bfloat16", "--device", "cuda"],
                        VP8_FRAMES, FULL_H, FULL_W)
        row["k1_launches"] = launched = corr_fwd.launches - k0
        windows = row.pop("windows")
        assert windows == -(-(VP8_FRAMES - 1) // VIDEO_B), windows
        assert launched == 5 * windows == 15, (launched, windows)
        del row["runner"], row["bytes_uploaded"]
        cli_rows[tag] = row
        log(f"[19] (b) extract_video --mode arrows B={VIDEO_B} bf16, {tag} "
            f"({VP8_FRAMES} frames {FULL_H}x{FULL_W}): {row['fps']!r} fps "
            f"over the run ({row['run_s']!r} s, fill {row['fill_s']:.2f} "
            f"s); decode thread busy {row['decode_ms']!r} ms a frame "
            f"({row['decode_share']:.1%}), draw {row['draw_share']:.1%}, "
            f"encode {row['encode_share']:.1%}; {windows} windows, K1 "
            f"{launched} launches; {card}")
    launches["cli"] = sum(r["k1_launches"] for r in cli_rows.values())

    # (c) capture_frame at the second key frame
    png = os.path.join(tmp, "vp8_frame.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([webm, str(VP8_CAPTURE), png]) == 0
    with open(png, "rb") as f:
        got = decode_png(f.read())[..., ::-1]
    assert pixel_digest(got) == new[VP8_CLIP]["sha256"][VP8_CAPTURE]
    log(f"[19] (c) capture_frame at frame {VP8_CAPTURE} of the WebM equals "
        f"cv2.VideoCapture's digest")

    # (d) the pseudo regime over a .webm of the first frames (384x512)
    train_webm = os.path.join(tmp, "train.webm")
    webm_head(webm, train_webm, VP8_TRAIN_FRAMES)
    out_dir = os.path.join(tmp, "vp8_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", train_webm, "--pretrained",
        ckpt, "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (VP8_TRAIN_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert [r["step"] for r in recs] == list(range(1, steps + 1)), recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[19] (d) cli/train --regime pseudo over a .webm of "
        f"{VP8_TRAIN_FRAMES} frames ({FULL_H}x{FULL_W} -> 384x512), {steps} "
        f"steps at batch {TRAIN_B}: losses {[r['loss'] for r in recs]}; "
        f"K1/B1 launches {launches['pseudo']} (5 and 5 a step); "
        f"{wall_t:.2f} s wall; {card}")

    # (e) host ms a 436x1024 frame on one thread: VP8 decode beside the
    # MPEG-4 Part 2 decode of the same frames (the port's encoder), each
    # to planes, then swscale's conversion to BGR
    mp4 = os.path.join(tmp, "vp8_frames.mp4")
    wr = vio.Mpeg4Writer(mp4, 25.0, (FULL_W, FULL_H))
    for fr in frames:
        wr.write(fr)
    wr.release()
    host = {}
    for codec, box, dec in (("vp8", MkvFile(webm), vp8.Decoder),
                            ("mpeg4", vio.EncodedVideo(mp4).box, None)):
        with open(box.path, "rb") as f:
            samples = [box.sample(f, i) for i in range(VP8_FRAMES)]
        ms, planes = host_decode(
            dec or (lambda b=box: Decoder(b.dsi, what=b.path)), samples)
        host[codec] = {"decode_ms": ms, "convert_ms": convert_ms(planes),
                       "bytes_a_frame": sum(map(len, samples)) / VP8_FRAMES}
    v, m = host["vp8"], host["mpeg4"]
    log(f"[19] (e) host ms a {FULL_H}x{FULL_W} frame on one thread: VP8 "
        f"decode {v['decode_ms']!r} ({v['bytes_a_frame']:.0f} bytes a "
        f"frame), MPEG-4 Part 2 {m['decode_ms']!r} ({m['bytes_a_frame']:.0f} "
        f"bytes); conversion to BGR {v['convert_ms']!r}; {card}")

    # (f) what the port imported
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"
    phase_s = time.perf_counter() - t_phase
    log(f"[19] (f) cv2, PIL, jax not imported; phase 19 took {phase_s:.1f} "
        f"s; {card}")
    return {"fixtures": len(new), "cli": cli_rows, "host_decode": host,
            "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


# ------------------------------------------------------------ phase 20

# VP9 on the card machine, read as cv2.VideoCapture reads it
# (runtime/vp9.cpp: FFmpeg's vp9 decoder in host C++, behind io/mkv, io/mp4
# and io/avi): the committed fixtures' cv2 digests, then the committed
# 436x1024 VP9 WebM (the Sintel pair alternating, 13 frames, key frames at
# 0 and 12, 4 tile columns; no VP9 encoder there) through the entry points
VP9_CLIP = "vp9_sintel_436x1024.webm"


def phase_vp9(sd, tmp, corr_fwd, corr_bwd, card: str):
    """VP9 through the port's entry points on the card machine: (a) the
    VP9 fixtures (and the VP8 clamping_type one) equal cv2's digests, (b)
    the video CLI over the 436x1024 WebM, over a .y4m of its frames and
    with .mkv out, (c) capture_frame, (d) the pseudo regime over a VP9
    .webm, (e) host ms to decode a frame, VP9 beside VP8 and MPEG-4 Part 2
    on the same frames, (f) no cv2, PIL or jax imported.  Returns its
    results, each path's K1 (and B1) launches among them."""
    import contextlib
    import io
    import numpy as np
    import torch
    from opticalflow_tpu_torch.cli import capture_frame
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.io.images import decode_png
    from opticalflow_tpu_torch.io.mkv import MkvFile
    from opticalflow_tpu_torch.runtime import vp8, vp9
    from opticalflow_tpu_torch.runtime.mpeg4 import Decoder

    t_phase = time.perf_counter()
    launches = {}

    # (a) the fixtures: cv2's writer in four containers, the size patches,
    # libvpx's settings (a size change among them), the colour ones
    t0 = time.perf_counter()
    manifest = video_manifest()
    os.environ["OPENCV_FFMPEG_THREADS"] = str(manifest["ffmpeg_threads"])
    new = fixtures_of(manifest, "vp9")
    checked = check_fixtures(new)
    n_frames, refused = checked["frames"], checked["refused"]
    features = sorted({f for w in new.values()
                       for f in w.get("vp9_features", [])})
    log(f"[20] (a) {len(new) - len(refused)} fixtures (VP9 in .webm/.mkv/"
        f".mp4/.avi, size patches, libvpx's alt-ref/compound/adaptive/"
        f"segmented/lossless/tiled/error-resilient/colour streams, "
        f"rewritten headers; the VP8 clamping_type one at "
        f"{manifest['ffmpeg_threads']} FFmpeg threads) decoded to "
        f"cv2.VideoCapture's {n_frames} frame digests and its "
        f"fps/size/count, {checked['seeks']} seeks to the frames cv2's "
        f"read, in {time.perf_counter() - t0:.2f} s; refused as "
        f"item 8: {refused}; features reached: {features}; {card}")

    # (b) the video CLI over the WebM, the same frames as a .y4m, and the
    # WebM again with .mkv out
    webm = os.path.join(MP4_DIR, VP9_CLIP)
    frames = list(vio.read_frames(webm))
    assert len(frames) == VP8_FRAMES and frames[0].shape == (FULL_H, FULL_W,
                                                              3)
    y4m = os.path.join(tmp, "vp9.y4m")
    write_clip(y4m, frames)
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    cli_rows = {}
    for tag, src, out in (("webm", webm, "out_webm.y4m"),
                          ("y4m", y4m, "out_y4m.y4m"),
                          ("webm_to_mkv", webm, "out_webm.mkv")):
        k0 = corr_fwd.launches
        row = video_cli([src, os.path.join(tmp, out), "--ckpt", ckpt,
                         "--mode", "arrows", "--batch", str(VIDEO_B),
                         "--dtype", "bfloat16", "--device", "cuda"],
                        VP8_FRAMES, FULL_H, FULL_W)
        row["k1_launches"] = launched = corr_fwd.launches - k0
        windows = row.pop("windows")
        assert windows == -(-(VP8_FRAMES - 1) // VIDEO_B), windows
        assert launched == 5 * windows == 15, (launched, windows)
        del row["runner"], row["bytes_uploaded"]
        cli_rows[tag] = row
        log(f"[20] (b) extract_video --mode arrows B={VIDEO_B} bf16, {tag} "
            f"({VP8_FRAMES} frames {FULL_H}x{FULL_W}): {row['fps']!r} fps "
            f"over the run ({row['run_s']!r} s, fill {row['fill_s']:.2f} "
            f"s); decode thread busy {row['decode_ms']!r} ms a frame "
            f"({row['decode_share']:.1%}), draw {row['draw_share']:.1%}, "
            f"encode {row['encode_share']:.1%}; {windows} windows, K1 "
            f"{launched} launches; {card}")
    launches["cli"] = sum(r["k1_launches"] for r in cli_rows.values())

    # (c) capture_frame at the second key frame
    png = os.path.join(tmp, "vp9_frame.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([webm, str(VP8_CAPTURE), png]) == 0
    with open(png, "rb") as f:
        got = decode_png(f.read())[..., ::-1]
    assert pixel_digest(got) == new[VP9_CLIP]["sha256"][VP8_CAPTURE]
    log(f"[20] (c) capture_frame at frame {VP8_CAPTURE} of the WebM equals "
        f"cv2.VideoCapture's digest")

    # (d) the pseudo regime over a VP9 .webm of the first frames
    train_webm = os.path.join(tmp, "train_vp9.webm")
    webm_head(webm, train_webm, VP8_TRAIN_FRAMES, b"V_VP9")
    out_dir = os.path.join(tmp, "vp9_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", train_webm, "--pretrained",
        ckpt, "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (VP8_TRAIN_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert [r["step"] for r in recs] == list(range(1, steps + 1)), recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[20] (d) cli/train --regime pseudo over a VP9 .webm of "
        f"{VP8_TRAIN_FRAMES} frames ({FULL_H}x{FULL_W} -> 384x512), {steps} "
        f"steps at batch {TRAIN_B}: losses {[r['loss'] for r in recs]}; "
        f"K1/B1 launches {launches['pseudo']} (5 and 5 a step); "
        f"{wall_t:.2f} s wall; {card}")

    # (e) host ms a 436x1024 frame on one thread: VP9 decode beside VP8's
    # (the committed VP8 WebM of the same Sintel frames) and MPEG-4 Part
    # 2's (the port's encoder over the VP9 frames), each to planes, then
    # swscale's conversion to BGR
    mp4 = os.path.join(tmp, "vp9_frames.mp4")
    wr = vio.Mpeg4Writer(mp4, 25.0, (FULL_W, FULL_H))
    for fr in frames:
        wr.write(fr)
    wr.release()
    host = {}
    for codec, box, dec in (
            ("vp9", MkvFile(webm), vp9.Decoder),
            ("vp8", MkvFile(os.path.join(MP4_DIR, VP8_CLIP)), vp8.Decoder),
            ("mpeg4", vio.EncodedVideo(mp4).box, None)):
        with open(box.path, "rb") as f:
            samples = [box.sample(f, i) for i in range(VP8_FRAMES)]
        ms, planes = host_decode(
            dec or (lambda b=box: Decoder(b.dsi, what=b.path)), samples)
        host[codec] = {"decode_ms": ms, "convert_ms": convert_ms(planes),
                       "bytes_a_frame": sum(map(len, samples)) / VP8_FRAMES}
    v9, v8, m = host["vp9"], host["vp8"], host["mpeg4"]
    log(f"[20] (e) host ms a {FULL_H}x{FULL_W} frame on one thread: VP9 "
        f"decode {v9['decode_ms']!r} ({v9['bytes_a_frame']:.0f} bytes a "
        f"frame), VP8 {v8['decode_ms']!r} ({v8['bytes_a_frame']:.0f} bytes), "
        f"MPEG-4 Part 2 {m['decode_ms']!r} ({m['bytes_a_frame']:.0f} bytes); "
        f"conversion to BGR {v9['convert_ms']!r}; {card}")

    # (f) what the port imported
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"
    phase_s = time.perf_counter() - t_phase
    log(f"[20] (f) cv2, PIL, jax not imported; phase 20 took {phase_s:.1f} "
        f"s; {card}")
    return {"fixtures": len(new) - len(refused), "refused": refused,
            "features": features, "cli": cli_rows, "host_decode": host,
            "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


MPEG12_CLIP = "mpeg2_sintel_436x1024.mpg"
MPEG12_SEEKS = "mpeg2_176x144.mpg"   # capture_frame's clip: cv2 seeks it
MPEG12_CAPTURE = 13      # a B-picture (display order I0 B1 B2 P3 ... B13)
# the pseudo regime's clip: the Sintel clip's first 10 pictures with a PTS
# on each (every seek exact; cv2's own muxer's seeks near the start read
# nothing), 9 pairs: 2 pseudo steps at batch 4
MPEG12_TRAIN = "mpeg2_sintel_head_436x1024.mpg"
MPEG12_TRAIN_FRAMES = 10


def phase_mpeg12(sd, tmp, corr_fwd, corr_bwd, card: str):
    """MPEG-1 and MPEG-2 through the port's entry points on the card
    machine: (a) the fixtures (.mpg, .avi, .mkv, .mp4) equal cv2's digests,
    fps, size and count, and each recorded seek reads cv2's frame; (b) the
    video CLI over the 436x1024 MPEG-2 .mpg, over a .y4m of its frames and
    with .mkv out, (c) capture_frame at a B-picture, (d) the pseudo regime
    over an .mpg, (e) host ms to decode a frame, MPEG-2 beside MPEG-4 Part
    2, VP8 and VP9 on the same frames, (f) no cv2, PIL or jax imported.
    Returns its results, each path's K1 (and B1) launches among them."""
    import contextlib
    import io
    import numpy as np
    import torch
    from opticalflow_tpu_torch.cli import capture_frame
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.io.images import decode_png
    from opticalflow_tpu_torch.io.mkv import MkvFile
    from opticalflow_tpu_torch.io.mpegps import MpegPsFile
    from opticalflow_tpu_torch.runtime import mpeg12, vp8, vp9
    from opticalflow_tpu_torch.runtime.mpeg4 import Decoder

    t_phase = time.perf_counter()
    launches = {}

    # (a) the fixtures: cv2's writer in four containers, the size patches,
    # libavcodec's tools and the rewritten headers; the interlaced one is
    # refused
    t0 = time.perf_counter()
    new = fixtures_of(video_manifest(), "mpeg12")
    checked = check_fixtures(new)
    n_frames, n_seeks, refused = (checked[k] for k in ("frames", "seeks",
                                                       "refused"))
    features = sorted({f for w in new.values()
                       for f in w.get("mpeg12_features", [])})
    log(f"[21] (a) {len(new) - len(refused)} fixtures (MPEG-1 and MPEG-2 "
        f"in .mpg/.avi/.mkv/.mp4, odd-size patches, a still, libavcodec's "
        f"tools and rewritten headers) decoded to cv2.VideoCapture's "
        f"{n_frames} frame digests and its fps/size/count, {n_seeks} seeks "
        f"to the frames cv2's read (quirks included) in "
        f"{time.perf_counter() - t0:.2f} s; refused as item 8: {refused}; "
        f"features reached: {features}; {card}")

    # (b) the video CLI over the .mpg, the same frames as a .y4m, and the
    # .mpg again with .mkv out
    mpg = os.path.join(MP4_DIR, MPEG12_CLIP)
    frames = list(vio.read_frames(mpg))
    assert len(frames) == VP8_FRAMES and frames[0].shape == (FULL_H, FULL_W,
                                                              3)
    y4m = os.path.join(tmp, "mpeg2.y4m")
    write_clip(y4m, frames)
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    cli_rows = {}
    for tag, src, out in (("mpg", mpg, "out_mpg.y4m"),
                          ("y4m", y4m, "out_y4m.y4m"),
                          ("mpg_to_mkv", mpg, "out_mpg.mkv")):
        k0 = corr_fwd.launches
        row = video_cli([src, os.path.join(tmp, out), "--ckpt", ckpt,
                         "--mode", "arrows", "--batch", str(VIDEO_B),
                         "--dtype", "bfloat16", "--device", "cuda"],
                        VP8_FRAMES, FULL_H, FULL_W)
        row["k1_launches"] = launched = corr_fwd.launches - k0
        windows = row.pop("windows")
        assert windows == -(-(VP8_FRAMES - 1) // VIDEO_B), windows
        assert launched == 5 * windows == 15, (launched, windows)
        del row["runner"], row["bytes_uploaded"]
        cli_rows[tag] = row
        log(f"[21] (b) extract_video --mode arrows B={VIDEO_B} bf16, {tag} "
            f"({VP8_FRAMES} frames {FULL_H}x{FULL_W}): {row['fps']!r} fps "
            f"over the run ({row['run_s']!r} s, fill {row['fill_s']:.2f} "
            f"s); decode thread busy {row['decode_ms']!r} ms a frame "
            f"({row['decode_share']:.1%}), draw {row['draw_share']:.1%}, "
            f"encode {row['encode_share']:.1%}; {windows} windows, K1 "
            f"{launched} launches; {card}")
    launches["cli"] = sum(r["k1_launches"] for r in cli_rows.values())

    # (c) capture_frame at a B-picture of the 176x144 MPEG-2 .mpg (cv2's
    # seeks in the Sintel .mpg read nothing past frame 0)
    seeks = os.path.join(MP4_DIR, MPEG12_SEEKS)
    png = os.path.join(tmp, "mpeg2_frame.png")
    with contextlib.redirect_stdout(io.StringIO()):
        assert capture_frame.main([seeks, str(MPEG12_CAPTURE), png]) == 0
    with open(png, "rb") as f:
        got = decode_png(f.read())[..., ::-1]
    box = MpegPsFile(seeks)
    assert box.types[vio.EncodedVideo(seeks).display.index(
        MPEG12_CAPTURE)] == 3
    want = new[MPEG12_SEEKS]
    assert pixel_digest(got) == want["sha256"][
        want["seeks"][str(MPEG12_CAPTURE)]]
    log(f"[21] (c) capture_frame at frame {MPEG12_CAPTURE} (a B-picture) of "
        f"{MPEG12_SEEKS} equals cv2.VideoCapture's digest")

    # (d) the pseudo regime over the Sintel clip's first 10 pictures
    train_mpg = os.path.join(MP4_DIR, MPEG12_TRAIN)
    assert vio.video_info(train_mpg)["frames"] == MPEG12_TRAIN_FRAMES
    out_dir = os.path.join(tmp, "mpeg2_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", train_mpg, "--pretrained",
        ckpt, "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (MPEG12_TRAIN_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert [r["step"] for r in recs] == list(range(1, steps + 1)), recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[21] (d) cli/train --regime pseudo over an MPEG-2 .mpg of "
        f"{MPEG12_TRAIN_FRAMES} frames ({FULL_H}x{FULL_W} -> 384x512), "
        f"{steps} steps at batch {TRAIN_B}: losses "
        f"{[r['loss'] for r in recs]}; K1/B1 launches {launches['pseudo']} "
        f"(5 and 5 a step); {wall_t:.2f} s wall; {card}")

    # (e) host ms a 436x1024 frame on one thread: MPEG-2 decode beside
    # MPEG-4 Part 2's (the port's encoder over the same frames), VP8's
    # and VP9's (the committed WebMs of the Sintel pair), each to planes,
    # then swscale's conversion to BGR
    mp4 = os.path.join(tmp, "mpeg2_frames.mp4")
    wr = vio.Mpeg4Writer(mp4, 25.0, (FULL_W, FULL_H))
    for fr in frames:
        wr.write(fr)
    wr.release()
    host = {}
    for codec, box, dec in (
            ("mpeg2", MpegPsFile(mpg), None),
            ("mpeg4", vio.EncodedVideo(mp4).box, None),
            ("vp8", MkvFile(os.path.join(MP4_DIR, VP8_CLIP)), vp8.Decoder),
            ("vp9", MkvFile(os.path.join(MP4_DIR, VP9_CLIP)), vp9.Decoder)):
        with open(box.path, "rb") as f:
            samples = [box.sample(f, i) for i in range(VP8_FRAMES)]
        make = dec or (mpeg12.Decoder if codec == "mpeg2" else
                       (lambda b=box: Decoder(b.dsi, what=b.path)))
        ms, planes = host_decode(make, samples)
        host[codec] = {"decode_ms": ms, "convert_ms": convert_ms(planes),
                       "bytes_a_frame": sum(map(len, samples)) / VP8_FRAMES}
    m2, m4, v8, v9 = (host[c] for c in ("mpeg2", "mpeg4", "vp8", "vp9"))
    log(f"[21] (e) host ms a {FULL_H}x{FULL_W} frame on one thread: MPEG-2 "
        f"decode {m2['decode_ms']!r} ({m2['bytes_a_frame']:.0f} bytes a "
        f"frame), MPEG-4 Part 2 {m4['decode_ms']!r} "
        f"({m4['bytes_a_frame']:.0f} bytes), VP8 {v8['decode_ms']!r} "
        f"({v8['bytes_a_frame']:.0f} bytes), VP9 {v9['decode_ms']!r} "
        f"({v9['bytes_a_frame']:.0f} bytes); conversion to BGR "
        f"{m2['convert_ms']!r}; {card}")

    # (f) what the port imported
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"
    phase_s = time.perf_counter() - t_phase
    log(f"[21] (f) cv2, PIL, jax not imported; phase 21 took {phase_s:.1f} "
        f"s; {card}")
    return {"fixtures": len(new) - len(refused), "refused": refused,
            "seeks": n_seeks, "features": features, "cli": cli_rows,
            "host_decode": host,
            "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


H263_CLIP = "h263_sintel_704x576.avi"     # 4CIF, libavcodec's h263
H263_H, H263_W = 576, 704
RESIZE_CLIP = "vp9_resize_sintel_436x1024.webm"   # 218x512 from frame 5


def phase_h263(sd, tmp, corr_fwd, corr_bwd, card: str):
    """VP9 size changes and H.263 through the port's entry points on the
    card machine: (a) the fixtures (H.263 in .avi/.3gp/.mov/.mkv, MPEG-4
    Part 2 in .3gp, and streams that change size: VP9, VP8, MPEG-4 Part 2,
    MPEG-2, H.263) equal cv2's digests, fps, size and count, and
    each recorded seek reads cv2's frame; (b) the video CLI over the 4CIF
    H.263 AVI and the resizing 436x1024 VP9 WebM, K1 on the card, bf16;
    (c) the pseudo regime over the resizing WebM's first 9 frames (K1 and
    B1); (d) host ms to decode a frame, H.263 beside MPEG-4 Part 2 of the
    same 4CIF frames and the resizing VP9 beside the unscaled VP9 of the
    same pair, and to convert a scaled picture; (e) no cv2, PIL or jax
    imported.  Returns its results, each path's K1 (and B1) launches among
    them."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.runtime import h263, vp9
    from opticalflow_tpu_torch.runtime.mpeg4 import Decoder, i420_to_bgr

    t_phase = time.perf_counter()
    launches = {}

    # (a) the fixtures
    t0 = time.perf_counter()
    new = fixtures_of(video_manifest(), "h263", "resize")
    checked = check_fixtures(new)
    assert not checked["refused"] and not checked["seeks_none"], checked
    n_frames, n_seeks = checked["frames"], checked["seeks"]
    features = {k: sorted({f for w in new.values()
                           for f in w.get(f"{k}_features", [])})
                for k in ("h263", "vp9")}
    log(f"[22] (a) {len(new)} fixtures (H.263 in .avi/.3gp/.mov/.mkv at "
        f"three sizes and 4CIF, Annex F, 8x8 vectors, GOB headers, PSUPP; "
        f"MPEG-4 Part 2 in .3gp; size changes in VP9, VP8, MPEG-4 Part 2, "
        f"MPEG-2 and H.263) decoded to cv2.VideoCapture's {n_frames} frame "
        f"digests and its fps/size/count, {n_seeks} seeks to the frames "
        f"cv2's read, in {time.perf_counter() - t0:.2f} s; features "
        f"reached: {features}; {card}")
    assert {"advanced_prediction", "gob_headers", "size_change"} <= set(
        features["h263"]) and "scaled_reference" in features["vp9"]

    # (b) the video CLI over the 4CIF H.263 AVI and the resizing WebM
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    cli_rows = {}
    for tag, src, h, w in (("h263_avi", H263_CLIP, H263_H, H263_W),
                           ("vp9_resize_webm", RESIZE_CLIP, FULL_H, FULL_W)):
        src = os.path.join(MP4_DIR, src)
        k0 = corr_fwd.launches
        row = video_cli([src, os.path.join(tmp, f"out_{tag}.y4m"), "--ckpt",
                         ckpt, "--mode", "arrows", "--batch", str(VIDEO_B),
                         "--dtype", "bfloat16", "--device", "cuda"],
                        VP8_FRAMES, h, w)
        row["k1_launches"] = launched = corr_fwd.launches - k0
        windows = row.pop("windows")
        assert windows == -(-(VP8_FRAMES - 1) // VIDEO_B), windows
        assert launched == 5 * windows == 15, (launched, windows)
        del row["runner"], row["bytes_uploaded"]
        cli_rows[tag] = row
        log(f"[22] (b) extract_video --mode arrows B={VIDEO_B} bf16, {tag} "
            f"({VP8_FRAMES} frames {h}x{w}): {row['fps']!r} fps over the "
            f"run ({row['run_s']!r} s, fill {row['fill_s']:.2f} s); decode "
            f"thread busy {row['decode_ms']!r} ms a frame "
            f"({row['decode_share']:.1%}), draw {row['draw_share']:.1%}, "
            f"encode {row['encode_share']:.1%}; {windows} windows, K1 "
            f"{launched} launches; {card}")
    launches["cli"] = sum(r["k1_launches"] for r in cli_rows.values())

    # (c) the pseudo regime over the resizing WebM's first 9 frames (the
    # size change at frame 5 inside): 8 pairs, 2 steps at batch 4
    train_webm = os.path.join(tmp, "vp9_resize_head.webm")
    webm_head(os.path.join(MP4_DIR, RESIZE_CLIP), train_webm,
              VP8_TRAIN_FRAMES, b"V_VP9")
    head = vio.EncodedVideo(train_webm)
    assert [p[0].shape for _, p in head.planes()] == \
        [(FULL_H, FULL_W)] * 5 + [(FULL_H // 2, FULL_W // 2)] * 4
    out_dir = os.path.join(tmp, "resize_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", train_webm, "--pretrained",
        ckpt, "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (VP8_TRAIN_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert [r["step"] for r in recs] == list(range(1, steps + 1)), recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[22] (c) cli/train --regime pseudo over the resizing VP9 WebM's "
        f"first {VP8_TRAIN_FRAMES} frames ({FULL_H}x{FULL_W}, 218x512 from "
        f"frame 5, scaled back), {steps} steps at batch {TRAIN_B}: losses "
        f"{[r['loss'] for r in recs]}; K1/B1 launches {launches['pseudo']} "
        f"(5 and 5 a step); {wall_t:.2f} s wall; {card}")

    # (d) host ms a frame on one thread: H.263 beside MPEG-4 Part 2 (the
    # port's encoder over the same 4CIF frames), the resizing VP9 (scaled
    # prediction on its 218x512 frames) beside the committed unscaled VP9
    # of the same pair; then the conversion to BGR, a scaled picture's too
    frames = list(vio.read_frames(os.path.join(MP4_DIR, H263_CLIP)))
    mp4 = os.path.join(tmp, "h263_frames.mp4")
    wr = vio.Mpeg4Writer(mp4, 25.0, (H263_W, H263_H))
    for fr in frames:
        wr.write(fr)
    wr.release()
    host, decoded = {}, {}
    for codec, path, make in (
            ("h263", os.path.join(MP4_DIR, H263_CLIP), h263.Decoder),
            ("mpeg4", mp4, None),
            ("vp9_resize", os.path.join(MP4_DIR, RESIZE_CLIP), vp9.Decoder),
            ("vp9", os.path.join(MP4_DIR, VP9_CLIP), vp9.Decoder)):
        box = vio.EncodedVideo(path).box
        with open(path, "rb") as f:
            samples = [box.sample(f, i) for i in range(VP8_FRAMES)]
        ms, planes = host_decode(
            make or (lambda b=box: Decoder(b.dsi, what=b.path)), samples)
        size = (box.width, box.height)
        decoded[codec] = planes
        host[codec] = {"decode_ms": ms,
                       "convert_ms": convert_ms(planes, size),
                       "bytes_a_frame": sum(map(len, samples)) / VP8_FRAMES,
                       "scaled_pictures": sum(p[0].shape != size[::-1]
                                              for p in planes)}
    small = decoded["vp9_resize"][-1]
    assert small[0].shape == (FULL_H // 2, FULL_W // 2)
    t0 = time.perf_counter()
    for _ in range(VP8_FRAMES):
        i420_to_bgr(*small, size=(FULL_W, FULL_H))
    host["scaled_convert_ms"] = (time.perf_counter() - t0) / VP8_FRAMES * 1e3
    hh, m4, vr, v9 = (host[c] for c in ("h263", "mpeg4", "vp9_resize",
                                        "vp9"))
    log(f"[22] (d) host ms a frame on one thread: H.263 {H263_H}x{H263_W} "
        f"decode {hh['decode_ms']!r} ({hh['bytes_a_frame']:.0f} bytes a "
        f"frame), MPEG-4 Part 2 of the same frames {m4['decode_ms']!r} "
        f"({m4['bytes_a_frame']:.0f} bytes); VP9 {FULL_H}x{FULL_W} with "
        f"{vr['scaled_pictures']} of {VP8_FRAMES} pictures at 218x512 "
        f"{vr['decode_ms']!r} ({vr['bytes_a_frame']:.0f} bytes), unscaled "
        f"{v9['decode_ms']!r} ({v9['bytes_a_frame']:.0f} bytes); a 218x512 "
        f"picture converted at {FULL_H}x{FULL_W} {host['scaled_convert_ms']!r} "
        f"ms; {card}")

    # (e) what the port imported
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"
    phase_s = time.perf_counter() - t_phase
    log(f"[22] (e) cv2, PIL, jax not imported; phase 22 took {phase_s:.1f} "
        f"s; {card}")
    return {"fixtures": len(new), "frames": n_frames, "seeks": n_seeks,
            "features": features, "cli": cli_rows, "host_decode": host,
            "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


# phase 23: transport streams, elementary streams, MPEG-4 in program
# streams and FFV1
TS_CLIP = "mpeg2_sintel_436x1024.ts"       # cv2's MPG2 writer, 13 frames
FFV1_CLIP = "ffv1_sintel_436x1024.mkv"     # cv2's FFV1 writer, 3 frames
FFV1_FRAMES = 3
TS_TRAIN = "mpeg2_sintel_low_delay_436x1024.ts"   # seeks exactly
TS_TRAIN_FRAMES = 10      # 9 pairs: 2 pseudo steps at batch 4
GENERIC_SEEK = ("mpeg2_cbr_176x144.m2v",)  # FFmpeg's generic index seek


def phase_streams(sd, tmp, corr_fwd, corr_bwd, card: str):
    """Transport streams, elementary streams and FFV1 through the port's
    entry points on the card machine: (a) the fixtures (MPEG-1/2 and
    MPEG-4 Part 2 in .ts/.m2ts/.mts, split PES packets and continuity gaps,
    .m1v/.m2v/.mpv/.h263/.263, MPEG-4 Part 2 in .mpg, FFV1 in
    .mkv/.avi/.mp4/.mov in every version, coder and colour space a fixture
    reaches) equal cv2's digests, fps, size and count, each recorded seek
    reads cv2's frame (or nothing where cv2 reads nothing), and H.263 and
    FFV1 muxed into .ts are refused; (b) the video CLI over the 436x1024
    MPEG-2 .ts and the FFV1 .mkv, K1 on the card, bf16; (c) the pseudo
    regime over a low-delay 436x1024 MPEG-2 .ts (K1 and B1); (d) host ms a
    frame to demux and decode each new kind beside MPEG-2 in .mpg on the
    same frames; (e) no cv2, PIL or jax imported.  Returns its results,
    each path's K1 (and B1) launches among them."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.io.elementary import ElementaryFile
    from opticalflow_tpu_torch.io.mkv import MkvFile
    from opticalflow_tpu_torch.io.mpegps import MpegPsFile
    from opticalflow_tpu_torch.io.mpegts import MpegTsFile
    from opticalflow_tpu_torch.runtime import ffv1, mpeg12

    t_phase = time.perf_counter()
    launches = {}

    # (a) the fixtures
    t0 = time.perf_counter()
    new = fixtures_of(video_manifest(), "stream")
    checked = check_fixtures(new, seek_refused=GENERIC_SEEK)
    n_frames, n_seeks, n_none, refused = (checked[k] for k in (
        "frames", "seeks", "seeks_none", "refused"))
    features = sorted({f for w in new.values()
                       for f in w.get("ffv1_features", [])})
    log(f"[23] (a) {len(new) - len(refused)} fixtures (MPEG-1/2 and MPEG-4 "
        f"Part 2 in .ts/.m2ts/.mts, elementary .m1v/.m2v/.mpv/.h263/.263, "
        f"MPEG-4 Part 2 in .mpg, FFV1 in .mkv/.avi/.mp4/.mov) decoded to "
        f"cv2.VideoCapture's {n_frames} frame digests and its "
        f"fps/size/count, {n_seeks} seeks to the frames cv2's read "
        f"({n_none} reading nothing, as cv2's, or refused) in "
        f"{time.perf_counter() - t0:.2f} s; refused: {refused}; FFV1 "
        f"features reached: {features}; {card}")
    assert len(refused) == 2 and {"version_0_1", "version_2", "version_3",
                                  "golomb", "range_custom", "rgb",
                                  "yuv420", "grey"} <= set(features)

    # (b) the video CLI over the MPEG-2 .ts and the FFV1 .mkv
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    cli_rows = {}
    for tag, src, n in (("mpeg2_ts", TS_CLIP, VP8_FRAMES),
                        ("ffv1_mkv", FFV1_CLIP, FFV1_FRAMES)):
        k0 = corr_fwd.launches
        row = video_cli([os.path.join(MP4_DIR, src),
                         os.path.join(tmp, f"out_{tag}.y4m"), "--ckpt", ckpt,
                         "--mode", "arrows", "--batch", str(VIDEO_B),
                         "--dtype", "bfloat16", "--device", "cuda"],
                        n, FULL_H, FULL_W)
        row["k1_launches"] = launched = corr_fwd.launches - k0
        windows = row.pop("windows")
        assert windows == -(-(n - 1) // VIDEO_B), windows
        assert launched == 5 * windows, (launched, windows)
        del row["runner"], row["bytes_uploaded"]
        cli_rows[tag] = row
        log(f"[23] (b) extract_video --mode arrows B={VIDEO_B} bf16, {tag} "
            f"({n} frames {FULL_H}x{FULL_W}): {row['fps']!r} fps over the "
            f"run ({row['run_s']!r} s, fill {row['fill_s']:.2f} s); decode "
            f"thread busy {row['decode_ms']!r} ms a frame "
            f"({row['decode_share']:.1%}), draw {row['draw_share']:.1%}, "
            f"encode {row['encode_share']:.1%}; {windows} windows, K1 "
            f"{launched} launches; {card}")
    launches["cli"] = sum(r["k1_launches"] for r in cli_rows.values())
    assert launches["cli"] == 15 + 5, launches

    # (c) the pseudo regime over the low-delay MPEG-2 .ts
    train_ts = os.path.join(MP4_DIR, TS_TRAIN)
    assert vio.video_info(train_ts)["frames"] == TS_TRAIN_FRAMES
    out_dir = os.path.join(tmp, "ts_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", train_ts, "--pretrained",
        ckpt, "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (TS_TRAIN_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert [r["step"] for r in recs] == list(range(1, steps + 1)), recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[23] (c) cli/train --regime pseudo over a low-delay MPEG-2 .ts "
        f"of {TS_TRAIN_FRAMES} frames ({FULL_H}x{FULL_W} -> 384x512), "
        f"{steps} steps at batch {TRAIN_B}: losses "
        f"{[r['loss'] for r in recs]}; K1/B1 launches {launches['pseudo']} "
        f"(5 and 5 a step); {wall_t:.2f} s wall; {card}")

    # (d) host ms a 436x1024 frame on one thread: open (demux: the file
    # walked, pictures split) and decode, MPEG-2 in .mpg beside the same
    # frames in .ts (cv2's writer), as an elementary .m2v (the .mpg's
    # pictures one after another) and FFV1 in .mkv (its 3 frames)
    m2v = os.path.join(tmp, "sintel.m2v")
    mpg = os.path.join(MP4_DIR, MPEG12_CLIP)
    with open(mpg, "rb") as f, open(m2v, "wb") as out:
        box = MpegPsFile(mpg)
        for i in range(len(box.sizes)):
            out.write(box.sample(f, i))
    host = {}
    for kind, path, opener in (("mpg", mpg, MpegPsFile),
                               ("ts", os.path.join(MP4_DIR, TS_CLIP),
                                MpegTsFile),
                               ("m2v", m2v, ElementaryFile),
                               ("ffv1_mkv", os.path.join(MP4_DIR, FFV1_CLIP),
                                MkvFile)):
        t0 = time.perf_counter()
        for _ in range(HOST_TIMED):
            box = opener(path)
        t1 = time.perf_counter()
        n = len(box.sizes)
        with open(path, "rb") as f:
            samples = [box.sample(f, i) for i in range(n)]
        ms, _ = host_decode(
            (lambda b=box: ffv1.Decoder(FULL_W, FULL_H, b.dsi))
            if kind == "ffv1_mkv" else mpeg12.Decoder, samples)
        host[kind] = {"open_ms": (t1 - t0) / HOST_TIMED / n * 1e3,
                      "decode_ms": ms,
                      "bytes_a_frame": sum(map(len, samples)) / n,
                      "frames": n}
    log("[23] (d) host ms a " + f"{FULL_H}x{FULL_W}" + " frame on one "
        "thread (open: the demuxer's walk and split; decode): " + "; ".join(
            f"{k} open {v['open_ms']!r}, decode {v['decode_ms']!r} "
            f"({v['bytes_a_frame']:.0f} bytes a frame)"
            for k, v in host.items()) + f"; {card}")

    # (e) what the port imported
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"
    phase_s = time.perf_counter() - t_phase
    log(f"[23] (e) cv2, PIL, jax not imported; phase 23 took {phase_s:.1f} "
        f"s; {card}")
    return {"fixtures": len(new) - len(refused), "refused": refused,
            "frames": n_frames, "seeks": n_seeks, "features": features,
            "cli": cli_rows, "host_decode": host,
            "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


# phase 24: H.263+, 16-bit colour PNG sequences, and transport streams
# whose PES headers carry a PTS alone
PLUS_CLIP = "h263_plus_sintel_436x1024.avi"   # libavcodec's h263p, 13 frames
# crafted H.263+ header bits (counted from the PSC) and the annex each
# names, which the port refuses: OPPTYPE's SAC, RPS and ISD, MPPTYPE's
# picture types 2 and 3, RPR and RRU
PLUS_REFUSED = ((46, "1", "Annex E"), (51, "1", "Annex N"),
                (52, "1", "Annex R"), (59, "010", "Annex M"),
                (59, "011", "Annex O"), (62, "1", "Annex P"),
                (63, "1", "Annex Q"))


def avi_head(src: str, dst: str, n: int) -> None:
    """The first ``n`` samples of an AVI remuxed by the port's AVI writer
    (same fourcc, keyframes flagged as in ``src``'s index)."""
    from opticalflow_tpu_torch.io.avi import AviFile, AviWriter
    box = AviFile(src)
    mux = AviWriter(dst, (box.width, box.height), (box.rate, box.scale),
                    fourcc=box.tag)
    keys = set(box.keyframes)
    with open(src, "rb") as f:
        for i in range(n):
            mux.write(box.sample(f, i), i in keys)
    mux.release()


def phase_plus(sd, tmp, corr_fwd, corr_bwd, card: str):
    """H.263+, 16-bit colour PNG sequences and PTS-only transport streams
    through the port's entry points on the card machine: (a) the fixtures
    (H.263+ with Annexes D, F, I, J, K, S and T, custom formats and clocks,
    a size change, in .avi/.h263/.mkv/.3gp; the PTS-only .ts/.m2ts/.mpg;
    16-bit RGB, RGBA and the 65,536-triple sheet) equal cv2's digests,
    fps, size and count, each recorded seek reads cv2's frame, and crafted
    headers of the refused annexes raise; (b) the video CLI over the
    436x1024 H.263+ AVI, K1 on the card, bf16; (c) the pseudo regime over
    its first 9 frames (K1 and B1); (d) host ms a 436x1024 frame to decode
    H.263+, beside baseline H.263 at 4CIF and MPEG-2 of the same pictures,
    and to convert a 16-bit frame; (e) no cv2, PIL or jax imported.
    Returns its results, each path's K1 (and B1) launches among them."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.io.images import encode_png
    from opticalflow_tpu_torch.runtime import h263, mpeg12
    from opticalflow_tpu_torch.runtime.mpeg4 import (ITEM_8, Unsupported,
                                                      rgb48_to_bgr)

    t_phase = time.perf_counter()
    launches = {}

    # (a) the fixtures
    t0 = time.perf_counter()
    new = fixtures_of(video_manifest(), "h263p", "pts_only", "png16")
    checked = check_fixtures(new)
    assert not checked["refused"] and not checked["seeks_none"], checked
    n_frames, n_seeks = checked["frames"], checked["seeks"]
    features = sorted({f for w in new.values()
                       for f in w.get("h263_features", [])})
    late = sum(w["seeks"][str(t)] != t for n, w in new.items()
               if n.endswith(".ts") or n.endswith(".m2ts") for t in range(13))
    plus = vio.EncodedVideo(os.path.join(MP4_DIR, "h263_plus_176x144.avi"))
    with open(plus.path, "rb") as f:
        packet = plus.box.sample(f, 0)
    bits = "".join(f"{b:08b}" for b in packet)
    refused = []
    for pos, value, annex in PLUS_REFUSED:
        crafted = bits[:pos] + value + bits[pos + len(value):]
        data = int(crafted, 2).to_bytes(len(packet), "big")
        try:
            h263.Decoder("crafted").decode(data)
        except Unsupported as e:
            assert annex in str(e) and ITEM_8 in str(e), (annex, str(e))
            refused.append(annex)
            continue
        raise AssertionError(f"{annex} was decoded")
    log(f"[24] (a) {len(new)} fixtures (H.263+ in .avi/.h263/.mkv/.3gp, "
        f"PTS-only MPEG-1/2 in .ts/.m2ts/.mpg, 16-bit RGB/RGBA PNG "
        f"sequences and the 65,536-triple sheet) decoded to "
        f"cv2.VideoCapture's {n_frames} frame digests and its "
        f"fps/size/count, {n_seeks} seeks to the frames cv2's read ({late} "
        f"of the PTS-only transport streams' seeks to 0-12 a GOP late, as "
        f"cv2's) in {time.perf_counter() - t0:.2f} s; crafted headers "
        f"refused: {refused}; H.263 features reached: {features}; {card}")
    assert len(refused) == len(PLUS_REFUSED) and late == 3 * 13
    assert {"umv", "advanced_prediction", "aic", "aic_vertical",
            "aic_horizontal", "loop_filter", "slices", "alt_inter_vlc",
            "alt_inter_retry", "modified_quant", "custom_format",
            "custom_clock", "rounding_type"} <= set(features)

    # (b) the video CLI over the 436x1024 H.263+ AVI
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    k0 = corr_fwd.launches
    row = video_cli([os.path.join(MP4_DIR, PLUS_CLIP),
                     os.path.join(tmp, "out_h263p.y4m"), "--ckpt", ckpt,
                     "--mode", "arrows", "--batch", str(VIDEO_B),
                     "--dtype", "bfloat16", "--device", "cuda"],
                    VP8_FRAMES, FULL_H, FULL_W)
    row["k1_launches"] = launched = corr_fwd.launches - k0
    windows = row.pop("windows")
    assert windows == -(-(VP8_FRAMES - 1) // VIDEO_B), windows
    assert launched == 5 * windows == 15, (launched, windows)
    del row["runner"], row["bytes_uploaded"]
    launches["cli"] = launched
    log(f"[24] (b) extract_video --mode arrows B={VIDEO_B} bf16, H.263+ "
        f"AVI ({VP8_FRAMES} frames {FULL_H}x{FULL_W}): {row['fps']!r} fps "
        f"over the run ({row['run_s']!r} s, fill {row['fill_s']:.2f} s); "
        f"decode thread busy {row['decode_ms']!r} ms a frame "
        f"({row['decode_share']:.1%}), draw {row['draw_share']:.1%}, "
        f"encode {row['encode_share']:.1%}; {windows} windows, K1 "
        f"{launched} launches; {card}")

    # (c) the pseudo regime over the H.263+ AVI's first 9 frames
    train_avi = os.path.join(tmp, "h263p_head.avi")
    avi_head(os.path.join(MP4_DIR, PLUS_CLIP), train_avi, VP8_TRAIN_FRAMES)
    assert vio.video_info(train_avi)["frames"] == VP8_TRAIN_FRAMES
    out_dir = os.path.join(tmp, "h263p_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", train_avi, "--pretrained",
        ckpt, "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (VP8_TRAIN_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert [r["step"] for r in recs] == list(range(1, steps + 1)), recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[24] (c) cli/train --regime pseudo over the H.263+ AVI's first "
        f"{VP8_TRAIN_FRAMES} frames ({FULL_H}x{FULL_W} -> 384x512), {steps} "
        f"steps at batch {TRAIN_B}: losses {[r['loss'] for r in recs]}; "
        f"K1/B1 launches {launches['pseudo']} (5 and 5 a step); "
        f"{wall_t:.2f} s wall; {card}")

    # (d) host ms a frame on one thread: H.263+ at 436x1024 beside
    # baseline H.263 at 4CIF and MPEG-2 of the same pair at 436x1024; the
    # conversion of a 16-bit 436x1024 RGB frame, alone and behind the PNG
    # decode of an image sequence
    host = {}
    for codec, path, make in (
            ("h263p", os.path.join(MP4_DIR, PLUS_CLIP), h263.Decoder),
            ("h263_4cif", os.path.join(MP4_DIR, H263_CLIP), h263.Decoder),
            ("mpeg2", os.path.join(MP4_DIR, MPEG12_CLIP), mpeg12.Decoder)):
        box = vio.EncodedVideo(path).box
        n = len(box.sizes)
        with open(path, "rb") as f:
            samples = [box.sample(f, i) for i in range(n)]
        host[codec] = {"decode_ms": host_decode(make, samples)[0],
                       "bytes_a_frame": sum(map(len, samples)) / n,
                       "frames": n, "size": [box.width, box.height]}
    pair = vio.read_frames(os.path.join(MP4_DIR, PLUS_CLIP), max_frames=1)
    rgb16 = next(iter(pair))[..., ::-1].astype(np.uint16) * 257
    rgb48_to_bgr(rgb16)
    t0 = time.perf_counter()
    for _ in range(HOST_TIMED):
        rgb48_to_bgr(rgb16)
    host["rgb48_convert_ms"] = (time.perf_counter() - t0) / HOST_TIMED * 1e3
    seq = os.path.join(tmp, "deep")
    os.makedirs(seq)
    with open(os.path.join(seq, "0.png"), "wb") as f:
        f.write(encode_png(rgb16))
    pattern = os.path.join(seq, "%d.png")
    t0 = time.perf_counter()
    for _ in range(HOST_TIMED):
        frame = vio.read_frame(pattern, 0)
    host["png16_read_ms"] = (time.perf_counter() - t0) / HOST_TIMED * 1e3
    assert frame.shape == (FULL_H, FULL_W, 3)
    hp, hb, m2 = (host[c] for c in ("h263p", "h263_4cif", "mpeg2"))
    log(f"[24] (d) host ms a frame on one thread: H.263+ {FULL_H}x{FULL_W} "
        f"decode {hp['decode_ms']!r} ({hp['bytes_a_frame']:.0f} bytes a "
        f"frame), baseline H.263 {H263_H}x{H263_W} {hb['decode_ms']!r} "
        f"({hb['bytes_a_frame']:.0f} bytes), MPEG-2 {FULL_H}x{FULL_W} of "
        f"the same pair {m2['decode_ms']!r} ({m2['bytes_a_frame']:.0f} "
        f"bytes); a 16-bit {FULL_H}x{FULL_W} RGB frame converted "
        f"{host['rgb48_convert_ms']!r} ms, read from a PNG sequence "
        f"{host['png16_read_ms']!r} ms; {card}")

    # (e) what the port imported
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"
    phase_s = time.perf_counter() - t_phase
    log(f"[24] (e) cv2, PIL, jax not imported; phase 24 took {phase_s:.1f} "
        f"s; {card}")
    return {"fixtures": len(new), "frames": n_frames, "seeks": n_seeks,
            "late_seeks": late, "refused": refused, "features": features,
            "cli": row, "host_decode": host,
            "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


# phase 25: lossless intra video
LOSSLESS_CLIP = "hfyu_sintel_436x1024.avi"   # libavcodec's 4:2:2 median
UT_CLIP = "ut_sintel_436x1024.avi"           # cv2's Ut Video writer (ULY0)
LOSSLESS_FRAMES = 2      # the Sintel pair
LOSSLESS_TRAIN_FRAMES = 9     # the pair's packets in turn: 2 pseudo steps


class PngPackets:
    """PNG-in-AVI packets decoded one at a time as ``EncodedVideo`` decodes
    them (``host_decode``'s decoder interface)."""

    def __init__(self, video):
        self.video = video

    def decode(self, packet: bytes):
        return self.video._png(packet, self.video.path)


def avi_repeat(src: str, dst: str, n: int) -> None:
    """An AVI of ``n`` frames: ``src``'s packets in turn (the same fourcc,
    extradata and bit count), every frame a keyframe, by the port's AVI
    writer."""
    from opticalflow_tpu_torch.io.avi import AviFile, AviWriter
    box = AviFile(src)
    with open(src, "rb") as f:
        packets = [box.sample(f, i) for i in range(box.frames)]
    mux = AviWriter(dst, (box.width, box.height), (box.rate, box.scale),
                    fourcc=box.tag, extradata=box.dsi, bpc=box.bpc)
    for i in range(n):
        mux.write(packets[i % len(packets)], True)
    mux.release()


def lossless_refusals() -> list:
    """Crafted headers of the lossless layouts the port leaves out, each
    of which must raise Unsupported naming ROADMAP Queue 1 item 8: FFVHuff
    at 10 bits, HuffYUV's median predictor on RGB, Ut Video's 10-bit and
    packed families and its interlaced flag, an APNG-style PNG packet and
    24-bit BI_RGB.  Returns what each refusal named."""
    import struct
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.io.avi import AviWriter
    from opticalflow_tpu_torch.runtime import huffyuv, utvideo
    from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported
    gbrp = vio.EncodedVideo(os.path.join(MP4_DIR,
                                         "ffvh_gbrp_plane_53x37.avi")).box.dsi
    rgb = vio.EncodedVideo(os.path.join(MP4_DIR,
                                        "hfyu_rgb24_left_48x32.avi")).box.dsi
    ut = vio.EncodedVideo(os.path.join(MP4_DIR,
                                       "ut_uly2_left_48x32.avi")).box.dsi
    flags = struct.unpack("<I", ut[12:16])[0]
    cases = [
        ("10-bit", lambda: huffyuv.Decoder(
            53, 37, 24, gbrp[:1] + bytes([0x90]) + gbrp[2:])),
        ("median predictor", lambda: huffyuv.Decoder(
            48, 32, 24, bytes([2 | rgb[0] & 64]) + rgb[1:])),
        ("10-bit Ut Video", lambda: utvideo.Decoder(48, 32, "UQY2", ut)),
        ("packed Ut Video", lambda: utvideo.Decoder(48, 32, "UMY2", ut)),
        ("interlaced", lambda: utvideo.Decoder(
            48, 32, "ULY2", ut[:12] + struct.pack("<I", flags | 0x800)))]
    png = vio.EncodedVideo(os.path.join(MP4_DIR, "png_96x64.avi"))
    with open(png.path, "rb") as f:
        first = png.box.sample(f, 0)
    with tempfile.TemporaryDirectory() as tmp:
        apng, dib = os.path.join(tmp, "apng.avi"), os.path.join(tmp, "dib.avi")
        mux = AviWriter(apng, (96, 64), (25, 1), fourcc="MPNG")
        mux.write(first, True)
        mux.write(first[8:].replace(b"IDAT", b"fdAT"), True)
        mux.release()
        mux = AviWriter(dib, (48, 32), (25, 1), fourcc="\0\0\0\0", bpc=24)
        mux.write(bytes(48 * 32 * 3), True)
        mux.release()
        cases += [("APNG", lambda: list(vio.read_frames(apng))),
                  ("24-bit BI_RGB", lambda: list(vio.read_frames(dib)))]
        named = []
        for what, make in cases:
            try:
                make()
            except Unsupported as e:
                assert what in str(e) and ITEM_8 in str(e), (what, str(e))
                named.append(what)
                continue
            raise AssertionError(f"{what} was read")
    return named


def phase_lossless(sd, tmp, corr_fwd, corr_bwd, card: str):
    """Lossless intra video through the port's entry points on the card
    machine (host C++ ``runtime/huffyuv.cpp`` and ``runtime/utvideo.cpp``,
    PNG, raw layouts and Motion JPEG in QuickTime behind the AVI, Matroska
    and MP4 demuxers): (a) every fixture of the ``lossless`` group (cv2's
    writer: HFYU, FFVH, ULY0 and MPNG in .avi/.mkv/.mov, MPNG in .mp4,
    MJPG in .mov, Y800/GREY/YV12/RGBA; libavcodec's HuffYUV and FFVHuff
    predictors, layouts, classic tables, interlaced lines and per-frame
    tables, Ut Video's layouts, predictors, slices and BT.709, PNG's
    flavours, BI_RGB) equals cv2's digests, fps, size and count, each
    recorded seek reads cv2's frame, and crafted headers of the layouts
    left out raise; (b) the video CLI over the 436x1024 HuffYUV AVI, K1 on
    the card, bf16; (c) the pseudo regime over 9 frames of its packets (K1
    and B1); (d) host ms to decode a 436x1024 frame of HuffYUV, Ut Video
    and PNG in AVI beside FFV1 on the same pictures, and to convert each to
    BGR; (e) no cv2, PIL or jax imported.  Returns its results, each
    path's K1 (and B1) launches among them."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.io.avi import AviWriter
    from opticalflow_tpu_torch.io.images import encode_png
    from opticalflow_tpu_torch.runtime import ffv1, huffyuv, utvideo
    from opticalflow_tpu_torch.runtime.mpeg4 import i420_to_bgr, yuv_to_bgr

    t_phase = time.perf_counter()
    launches = {}

    # (a) the fixtures
    t0 = time.perf_counter()
    new = fixtures_of(video_manifest(), "lossless")
    checked = check_fixtures(new)
    assert not checked["refused"] and not checked["seeks_none"], checked
    n_frames, n_seeks = checked["frames"], checked["seeks"]
    features = {k: sorted({f for w in new.values()
                           for f in w.get(f"{k}_features", [])})
                for k in ("huffyuv", "utvideo")}
    assert set(features["huffyuv"]) == set(huffyuv.FEATURES), features
    assert set(features["utvideo"]) == set(utvideo.FEATURES), features
    refused = lossless_refusals()
    log(f"[25] (a) {len(new)} fixtures (HuffYUV, FFVHuff, Ut Video and PNG "
        f"in .avi/.mkv/.mov, PNG in .mp4, Motion JPEG in .mov, raw "
        f"Y800/GREY/YV12/RGBA/BI_RGB) decoded to cv2.VideoCapture's "
        f"{n_frames} frame digests and its fps/size/count, {n_seeks} seeks "
        f"to the frames cv2's read, in {time.perf_counter() - t0:.2f} s; "
        f"crafted headers refused: {refused}; every HuffYUV and Ut Video "
        f"feature reached; {card}")

    # (b) the video CLI over the 436x1024 HuffYUV AVI
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    clip = os.path.join(MP4_DIR, LOSSLESS_CLIP)
    k0 = corr_fwd.launches
    row = video_cli([clip, os.path.join(tmp, "out_hfyu.y4m"), "--ckpt", ckpt,
                     "--mode", "arrows", "--batch", str(VIDEO_B),
                     "--dtype", "bfloat16", "--device", "cuda"],
                    LOSSLESS_FRAMES, FULL_H, FULL_W)
    row["k1_launches"] = launched = corr_fwd.launches - k0
    windows = row.pop("windows")
    assert windows == 1 and launched == 5, (launched, windows)
    del row["runner"], row["bytes_uploaded"]
    launches["cli"] = launched
    log(f"[25] (b) extract_video --mode arrows B={VIDEO_B} bf16, HuffYUV "
        f"4:2:2 AVI ({LOSSLESS_FRAMES} frames {FULL_H}x{FULL_W}): "
        f"{row['fps']!r} fps over the run ({row['run_s']!r} s, fill "
        f"{row['fill_s']:.2f} s); decode thread busy {row['decode_ms']!r} ms "
        f"a frame ({row['decode_share']:.1%}); {windows} window, K1 "
        f"{launched} launches; {card}")

    # (c) the pseudo regime over 9 frames of the pair's packets
    train_avi = os.path.join(tmp, "hfyu_train.avi")
    avi_repeat(clip, train_avi, LOSSLESS_TRAIN_FRAMES)
    pair = list(vio.read_frames(clip))
    assert all(np.array_equal(f, pair[i % 2]) for i, f in
               enumerate(vio.read_frames(train_avi)))
    out_dir = os.path.join(tmp, "hfyu_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", train_avi, "--pretrained",
        ckpt, "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (LOSSLESS_TRAIN_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert [r["step"] for r in recs] == list(range(1, steps + 1)), recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[25] (c) cli/train --regime pseudo over {LOSSLESS_TRAIN_FRAMES} "
        f"frames of the HuffYUV pair ({FULL_H}x{FULL_W} -> 384x512), "
        f"{steps} steps at batch {TRAIN_B}: losses "
        f"{[r['loss'] for r in recs]}; K1/B1 launches {launches['pseudo']} "
        f"(5 and 5 a step); {wall_t:.2f} s wall; {card}")

    # (d) host ms a 436x1024 frame on one thread: decode, then convert to
    # BGR; HuffYUV 4:2:2, Ut Video 4:2:0 and PNG in AVI (the pair encoded
    # by the port's PNG encoder) beside FFV1 of the same pictures
    host = {}
    png_avi = os.path.join(tmp, "png_pair.avi")
    mux = AviWriter(png_avi, (FULL_W, FULL_H), (25, 1), fourcc="MPNG")
    for f in pair:
        mux.write(encode_png(np.ascontiguousarray(f[..., ::-1])), True)
    mux.release()
    assert all(np.array_equal(a, b) for a, b in
               zip(vio.read_frames(png_avi), pair))
    for codec, path in (("huffyuv", clip),
                        ("utvideo", os.path.join(MP4_DIR, UT_CLIP)),
                        ("ffv1", os.path.join(MP4_DIR, FFV1_CLIP)),
                        ("png", png_avi)):
        video = vio.EncodedVideo(path)
        box = video.box
        with open(path, "rb") as f:
            samples = [box.sample(f, i) for i in range(box.frames)]
        make = {"huffyuv": lambda b=box: huffyuv.Decoder(
                    FULL_W, FULL_H, b.bpc, b.dsi),
                "utvideo": lambda b=box: utvideo.Decoder(
                    FULL_W, FULL_H, b.tag, b.dsi),
                "ffv1": lambda b=box: ffv1.Decoder(FULL_W, FULL_H, b.dsi),
                "png": lambda v=video: PngPackets(v)}[codec]
        ms, got = host_decode(make, samples)
        if codec == "huffyuv":
            convert = lambda p: yuv_to_bgr(*p, (1, 0))  # noqa: E731
        elif codec in ("utvideo", "ffv1") and isinstance(got[0], tuple):
            convert = lambda p: i420_to_bgr(*p)  # noqa: E731
        else:
            convert = None      # BGR already (PNG; FFV1's RGB: a copy)
        conv_ms = 0.0
        if convert is not None:
            convert(got[0])
            t0 = time.perf_counter()
            for _ in range(HOST_TIMED):
                for p in got:
                    convert(p)
            conv_ms = (time.perf_counter() - t0) / HOST_TIMED / len(got) * 1e3
        host[codec] = {"decode_ms": ms, "convert_ms": conv_ms,
                       "bytes_a_frame": sum(map(len, samples)) / len(samples),
                       "frames": len(samples)}
    log("[25] (d) host ms a " + f"{FULL_H}x{FULL_W}" + " frame on one "
        "thread (decode, convert to BGR): " + "; ".join(
            f"{k} {v['decode_ms']!r} + {v['convert_ms']!r} "
            f"({v['bytes_a_frame']:.0f} bytes a frame)"
            for k, v in host.items()) + f"; {card}")

    # (e) what the port imported
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"
    phase_s = time.perf_counter() - t_phase
    log(f"[25] (e) cv2, PIL, jax not imported; phase 25 took {phase_s:.1f} "
        f"s; {card}")
    return {"fixtures": len(new), "frames": n_frames, "seeks": n_seeks,
            "refused": refused, "features": features, "cli": row,
            "host_decode": host,
            "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


# phase 26: MagicYUV, Sorenson H.263 and ASUS V1/V2
FLV_CLIP = "flv_sintel_436x1024.flv"     # libavcodec's flv, 13 frames
# a disposable picture right after the first key frame, skipped in order
FLV_SKIPPED = "flv_disposable_key_96x64.flv"
MAGY_CLIP = "magy_sintel_436x1024.avi"   # cv2's MagicYUV writer (4:2:0)
ASV_CLIP = "asv_sintel_436x1024.avi"     # cv2's ASV2 writer
FLV_FRAMES = 13


def magy_flv_refusals() -> list:
    """Crafted headers of what this slice leaves out, each of which must
    raise Unsupported naming ROADMAP Queue 1 item 8: MagicYUV at 10, 12
    and 14 bits and interlaced, FLV video of another codec (VP6; H.264
    is read since phase 32's slice) or with an enhanced-FLV header, an FLV whose metadata lacks its frame
    rate or duration, and a seek in an FLV whose timestamps OpenCV numbers
    otherwise than its frames.  Returns what each refusal named."""
    import struct
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.runtime import magicyuv
    from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported
    magy = vio.EncodedVideo(os.path.join(MP4_DIR,
                                         "magy_yuv422p_left_48x32.avi"))
    with open(magy.path, "rb") as f:
        p = magy.box.sample(f, 0)
    cases = [(what, lambda q=q: magicyuv.Decoder("crafted").decode(q))
             for what, q in (("10-bit", p[:9] + b"\x6c" + p[10:]),
                             ("12-bit", p[:9] + b"\x6f" + p[10:]),
                             ("14-bit", p[:9] + b"\x71" + p[10:]),
                             ("interlaced", p[:12] + bytes([p[12] | 2])
                              + p[13:]))]
    with tempfile.TemporaryDirectory() as tmp:
        for what, flags in (("VP6", 0x14), ("enhanced FLV", 0x90)):
            path = os.path.join(tmp, f"{flags}.flv")
            body = bytes([flags]) + bytes(8)
            tag = bytes([9]) + len(body).to_bytes(3, "big") + bytes(7) + body
            with open(path, "wb") as f:
                f.write(b"FLV\x01\x01" + struct.pack(">I", 9) + bytes(4) + tag
                        + struct.pack(">I", 11 + len(body)))
            cases.append((what, lambda q=path: vio.EncodedVideo(q)))
        src = os.path.join(MP4_DIR, "flv_96x64.flv")
        with open(src, "rb") as f:
            data = bytearray(f.read())
        for key in (b"framerate", b"duration"):
            path = os.path.join(tmp, f"no_{key.decode()}.flv")
            with open(path, "wb") as f:
                f.write(data.replace(key, key[:-1] + b"X"))
            cases.append((key.decode(), lambda q=path: vio.EncodedVideo(q)))
        # timestamps 80 ms apart at 25 fps: OpenCV numbers them 0, 2, 4...
        for offset in vio.EncodedVideo(src).box.offsets:
            ms = int.from_bytes(data[offset - 8:offset - 5], "big")
            data[offset - 8:offset - 5] = (2 * ms).to_bytes(3, "big")
        path = os.path.join(tmp, "numbered.flv")
        with open(path, "wb") as f:
            f.write(data)
        cases.append(("numbers otherwise",
                      lambda q=path: vio.EncodedVideo(q).frame(3)))
        named = []
        for what, make in cases:
            try:
                make()
            except Unsupported as e:
                assert what in str(e) and ITEM_8 in str(e), (what, str(e))
                named.append(what)
                continue
            raise AssertionError(f"{what} was read")
    return named


def phase_magy_flv_asv(sd, tmp, corr_fwd, corr_bwd, card: str):
    """MagicYUV, Sorenson H.263 and ASUS V1/V2 through the port's entry
    points on the card machine (host C++ ``runtime/magicyuv.cpp``,
    ``runtime/asv.cpp`` and ``runtime/h263.cpp``'s Sorenson reading behind
    the FLV, AVI, Matroska and MP4 demuxers): (a) every fixture of the
    ``magicyuv``, ``sorenson`` and ``asv`` groups (cv2's writer: M8Y0,
    ASV1 and ASV2 in .avi/.mkv/.mov, FLV1 in .flv/.avi/.mkv/.mov;
    libavcodec's MagicYUV layouts, predictors and slices, Sorenson's
    escapes and version 0, ASV's quantisers and partial macroblocks;
    rewritten headers) equals cv2's digests, fps, size and count, each
    recorded seek reads cv2's frame, and crafted headers of what is left
    out raise; (b) the video
    CLI over the 436x1024 Sorenson .flv, K1 on the card, bf16; (c) the
    pseudo regime over the same .flv (K1 and B1); (d) host ms to decode
    and to convert a 436x1024 frame of MagicYUV, Sorenson and ASV2, beside
    Ut Video and H.263+; (e) no cv2, PIL or jax imported.  Returns its
    results, each path's K1 (and B1) launches among them."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.runtime import asv, h263, magicyuv, utvideo
    from opticalflow_tpu_torch.runtime.mpeg4 import i420_to_bgr, yuv_to_bgr

    t_phase = time.perf_counter()
    launches = {}

    # (a) the fixtures
    t0 = time.perf_counter()
    new = fixtures_of(video_manifest(), "magicyuv", "sorenson", "asv")
    checked = check_fixtures(new)
    assert not checked["refused"] and not checked["seeks_none"], checked
    n_frames, n_seeks = checked["frames"], checked["seeks"]
    features = {k: sorted({f for w in new.values()
                           for f in w.get(f"{k}_features", [])})
                for k in ("magicyuv", "flv", "asv")}
    assert set(features["magicyuv"]) == set(magicyuv.FEATURES), features
    assert set(h263.SORENSON_FEATURES) <= set(features["flv"]), features
    assert set(features["asv"]) == set(asv.FEATURES), features
    # reading on in order past the disposable picture FFmpeg skips in a
    # capture just opened: cv2's t-th read, with no seek between
    want = new[FLV_SKIPPED]
    video = vio.EncodedVideo(os.path.join(MP4_DIR, FLV_SKIPPED))
    assert [pixel_digest(video.read(t)) for t in range(want["decoded"])
            ] == want["sha256"], FLV_SKIPPED
    refused = magy_flv_refusals()
    log(f"[26] (a) {len(new)} fixtures (MagicYUV, ASV1 and ASV2 in "
        f".avi/.mkv/.mov, Sorenson H.263 in .flv/.avi/.mkv/.mov) decoded to "
        f"cv2.VideoCapture's {n_frames} frame digests and its "
        f"fps/size/count, {n_seeks} seeks to the frames cv2's read, "
        f"{want['decoded']} reads in order past a skipped disposable "
        f"picture in {time.perf_counter() - t0:.2f} s; crafted headers "
        f"refused: {refused}; every MagicYUV, Sorenson and ASV feature "
        f"reached; {card}")

    # (b) the video CLI over the 436x1024 Sorenson .flv
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    clip = os.path.join(MP4_DIR, FLV_CLIP)
    k0 = corr_fwd.launches
    row = video_cli([clip, os.path.join(tmp, "out_flv.y4m"), "--ckpt", ckpt,
                     "--mode", "arrows", "--batch", str(VIDEO_B),
                     "--dtype", "bfloat16", "--device", "cuda"],
                    FLV_FRAMES, FULL_H, FULL_W)
    row["k1_launches"] = launched = corr_fwd.launches - k0
    windows = row.pop("windows")
    assert windows == -(-(FLV_FRAMES - 1) // VIDEO_B), windows
    assert launched == 5 * windows == 15, (launched, windows)
    del row["runner"], row["bytes_uploaded"]
    launches["cli"] = launched
    log(f"[26] (b) extract_video --mode arrows B={VIDEO_B} bf16, Sorenson "
        f".flv ({FLV_FRAMES} frames {FULL_H}x{FULL_W}): {row['fps']!r} fps "
        f"over the run ({row['run_s']!r} s, fill {row['fill_s']:.2f} s); "
        f"decode thread busy {row['decode_ms']!r} ms a frame "
        f"({row['decode_share']:.1%}); {windows} windows, K1 {launched} "
        f"launches; {card}")

    # (c) the pseudo regime over the .flv (pairs read in any order: seeks)
    out_dir = os.path.join(tmp, "flv_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", clip, "--pretrained", ckpt,
        "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (FLV_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert [r["step"] for r in recs] == list(range(1, steps + 1)), recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[26] (c) cli/train --regime pseudo over the Sorenson .flv "
        f"({FLV_FRAMES} frames {FULL_H}x{FULL_W} -> 384x512), {steps} steps "
        f"at batch {TRAIN_B}: losses {[r['loss'] for r in recs]}; K1/B1 "
        f"launches {launches['pseudo']} (5 and 5 a step); {wall_t:.2f} s "
        f"wall; {card}")

    # (d) host ms a 436x1024 frame on one thread: decode, then convert to
    # BGR; MagicYUV 4:2:0, Sorenson and ASV2 beside Ut Video 4:2:0 and
    # H.263+ of the same pair
    host = {}
    for codec, name in (("magicyuv", MAGY_CLIP), ("sorenson", FLV_CLIP),
                        ("asv2", ASV_CLIP), ("utvideo", UT_CLIP),
                        ("h263p", PLUS_CLIP)):
        video = vio.EncodedVideo(os.path.join(MP4_DIR, name))
        box = video.box
        with open(video.path, "rb") as f:
            samples = [box.sample(f, i) for i in range(len(box.sizes))]
        make = {"magicyuv": magicyuv.Decoder,
                "sorenson": lambda: h263.Decoder(sorenson=True),
                "asv2": lambda b=box: asv.Decoder(FULL_W, FULL_H, b.tag,
                                                  b.dsi),
                "utvideo": lambda b=box: utvideo.Decoder(FULL_W, FULL_H,
                                                         b.tag, b.dsi),
                "h263p": h263.Decoder}[codec]
        ms, got = host_decode(make, samples)
        conv = (lambda p: yuv_to_bgr(*p, (1, 1))) if codec == "magicyuv" \
            else (lambda p: i420_to_bgr(*p))
        conv(got[0])
        t0 = time.perf_counter()
        for _ in range(HOST_TIMED):
            for p in got:
                conv(p)
        host[codec] = {
            "decode_ms": ms,
            "convert_ms": (time.perf_counter() - t0) / HOST_TIMED / len(got)
            * 1e3,
            "bytes_a_frame": sum(map(len, samples)) / len(samples),
            "frames": len(samples)}
    log("[26] (d) host ms a " + f"{FULL_H}x{FULL_W}" + " frame on one "
        "thread (decode, convert to BGR): " + "; ".join(
            f"{k} {v['decode_ms']!r} + {v['convert_ms']!r} "
            f"({v['bytes_a_frame']:.0f} bytes a frame)"
            for k, v in host.items()) + f"; {card}")

    # (e) what the port imported
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"
    phase_s = time.perf_counter() - t_phase
    log(f"[26] (e) cv2, PIL, jax not imported; phase 26 took {phase_s:.1f} "
        f"s; {card}")
    return {"fixtures": len(new), "frames": n_frames, "seeks": n_seeks,
            "refused": refused,
            "features": features, "cli": row, "host_decode": host,
            "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


# phase 27: MS-MPEG4 v2/v3 and WMV7/WMV8 in AVI, Matroska, QuickTime, ASF
MSM_CLIP = "msm_sintel_436x1024.wmv"     # libavcodec's wmv2, 13 frames
MSM_FRAMES = 13
# three frames of the pair in each other codec (libavcodec, in AVI)
MSM_HOST = {"msmpeg4v2": "msm_sintel_msmpeg4v2_436x1024.avi",
            "msmpeg4v3": "msm_sintel_msmpeg4_436x1024.avi",
            "wmv1": "msm_sintel_wmv1_436x1024.avi", "wmv2": MSM_CLIP}


def msmpeg4_refusals() -> list:
    """Crafted headers of what this slice leaves out, each of which must
    raise Unsupported naming ROADMAP Queue 1 item 8: MS-MPEG4 v1's fourcc,
    WMV8 J-pictures, mspel motion and ABT blocks (the picture header's
    bits rewritten), its loop filter (an extradata bit), compressed ASF
    payloads and an ASF broadcast (whose count FFmpeg guesses).  Returns
    what each refusal named."""
    import struct
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.io.asf import FILE_PROPERTIES
    from opticalflow_tpu_torch.io.avi import AviWriter
    from opticalflow_tpu_torch.runtime import msmpeg4
    from opticalflow_tpu_torch.runtime.mpeg4 import ITEM_8, Unsupported

    def bit(data, at, value):
        b = bytearray(data)
        mask = 0x80 >> (at & 7)
        b[at >> 3] = b[at >> 3] | mask if value else b[at >> 3] & ~mask
        return bytes(b)

    wmv2 = vio.EncodedVideo(os.path.join(MP4_DIR, "msm_wmv2_96x64.avi"))
    with open(wmv2.path, "rb") as f:
        i_pic, p_pic = wmv2.box.sample(f, 0), wmv2.box.sample(f, 1)
    ext = wmv2.box.dsi

    def decode(*packets):
        dec = msmpeg4.Decoder("wmv2", 96, 64, ext, what="crafted")
        for q in packets:
            dec.decode(q)

    cases = [("J-pictures", lambda: decode(bit(i_pic, 13, 1))),
             ("mspel", lambda: decode(i_pic, bit(p_pic, 9, 1))),
             ("per macroblock", lambda: decode(i_pic, bit(p_pic, 10, 0))),
             ("other than 8x8",
              lambda: decode(i_pic, bit(bit(p_pic, 11, 1), 12, 0))),
             ("loop filter",
              lambda: msmpeg4.Decoder("wmv2", 96, 64, bit(ext, 17, 1)))]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "v1.avi")
        mux = AviWriter(path, (48, 32), (25, 1), fourcc="MPG4")
        mux.write(bytes(64), True)
        mux.release()
        cases.append(("MS-MPEG4 v1", lambda q=path: vio.EncodedVideo(q)))
        src = os.path.join(MP4_DIR, "msm_wmv2_96x64.wmv")
        box = vio.EncodedVideo(src).box
        with open(src, "rb") as f:
            data = f.read()
        at = box.pieces[0][0][0] - 11      # replicated data's length
        path = os.path.join(tmp, "compressed.wmv")
        with open(path, "wb") as f:
            f.write(data[:at] + b"\x01" + data[at + 1:])
        cases.append(("compressed ASF", lambda q=path: vio.EncodedVideo(q)))
        flags = data.find(FILE_PROPERTIES) + 24 + 64
        path = os.path.join(tmp, "broadcast.wmv")
        with open(path, "wb") as f:
            f.write(data[:flags] + struct.pack("<I", 3) + data[flags + 4:])
        cases.append(("play duration", lambda q=path: vio.EncodedVideo(q)))
        named = []
        for what, make in cases:
            try:
                make()
            except Unsupported as e:
                assert what in str(e) and ITEM_8 in str(e), (what, str(e))
                named.append(what)
                continue
            raise AssertionError(f"{what} was read")
    return named


def phase_msmpeg4(sd, tmp, corr_fwd, corr_bwd, card: str):
    """MS-MPEG4 v2/v3 and WMV7/WMV8 through the port's entry points on the
    card machine (host C++ ``runtime/msmpeg4.cpp`` behind ``io/asf.py``
    and the AVI, Matroska and MP4 demuxers): (a) every fixture of the
    ``msmpeg4`` group equals cv2's digests, fps, size and count, each
    recorded seek reads cv2's frame, and crafted headers of what is left
    out raise; (b) the video CLI over the 436x1024 WMV8 .wmv, K1 on the
    card, bf16; (c) the pseudo regime over the same .wmv (K1 and B1); (d)
    host ms to decode and to convert a 436x1024 frame of v2, v3, WMV7 and
    WMV8, beside H.263+ and Sorenson; (e) no cv2, PIL or jax imported.
    Returns its results, each path's K1 (and B1) launches among them."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.runtime import h263, msmpeg4

    t_phase = time.perf_counter()
    launches = {}

    # (a) the fixtures
    t0 = time.perf_counter()
    manifest = video_manifest()
    new = fixtures_of(manifest, "msmpeg4")
    checked = check_fixtures(new)
    assert not checked["refused"] and not checked["seeks_none"], checked
    n_frames, n_seeks = checked["frames"], checked["seeks"]
    features = sorted({f for w in new.values()
                       for f in w.get("msmpeg4_features", [])})
    unreached = [f for f in msmpeg4.FEATURES if f not in features]
    assert unreached == manifest["msmpeg4_unreached"], unreached
    refused = msmpeg4_refusals()
    log(f"[27] (a) {len(new)} fixtures (MP42, DIV3, WMV1 and WMV2 in "
        f".avi/.mkv/.mov/.wmv/.asf; libavcodec's streams) decoded to "
        f"cv2.VideoCapture's {n_frames} frame digests and its "
        f"fps/size/count, {n_seeks} seeks to the frames cv2's read in "
        f"{time.perf_counter() - t0:.2f} s; crafted headers refused: "
        f"{refused}; features reached {len(features)} of "
        f"{len(msmpeg4.FEATURES)} (none of the fixtures: {unreached}); "
        f"{card}")

    # (b) the video CLI over the 436x1024 WMV8 .wmv
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    clip = os.path.join(MP4_DIR, MSM_CLIP)
    k0 = corr_fwd.launches
    row = video_cli([clip, os.path.join(tmp, "out_wmv.y4m"), "--ckpt", ckpt,
                     "--mode", "arrows", "--batch", str(VIDEO_B),
                     "--dtype", "bfloat16", "--device", "cuda"],
                    MSM_FRAMES, FULL_H, FULL_W)
    row["k1_launches"] = launched = corr_fwd.launches - k0
    windows = row.pop("windows")
    assert windows == -(-(MSM_FRAMES - 1) // VIDEO_B), windows
    assert launched == 5 * windows == 15, (launched, windows)
    del row["runner"], row["bytes_uploaded"]
    launches["cli"] = launched
    log(f"[27] (b) extract_video --mode arrows B={VIDEO_B} bf16, WMV8 .wmv "
        f"({MSM_FRAMES} frames {FULL_H}x{FULL_W}): {row['fps']!r} fps over "
        f"the run ({row['run_s']!r} s, fill {row['fill_s']:.2f} s); decode "
        f"thread busy {row['decode_ms']!r} ms a frame "
        f"({row['decode_share']:.1%}); {windows} windows, K1 {launched} "
        f"launches; {card}")

    # (c) the pseudo regime over the .wmv (pairs read in any order: seeks)
    out_dir = os.path.join(tmp, "wmv_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", clip, "--pretrained", ckpt,
        "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (MSM_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert [r["step"] for r in recs] == list(range(1, steps + 1)), recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[27] (c) cli/train --regime pseudo over the WMV8 .wmv "
        f"({MSM_FRAMES} frames {FULL_H}x{FULL_W} -> 384x512), {steps} steps "
        f"at batch {TRAIN_B}: losses {[r['loss'] for r in recs]}; K1/B1 "
        f"launches {launches['pseudo']} (5 and 5 a step); {wall_t:.2f} s "
        f"wall; {card}")

    # (d) host ms a 436x1024 frame on one thread: decode, then convert to
    # BGR; the four codecs beside H.263+ and Sorenson of the same pair
    host = {}
    for codec, name in (*MSM_HOST.items(), ("sorenson", FLV_CLIP),
                        ("h263p", PLUS_CLIP)):
        video = vio.EncodedVideo(os.path.join(MP4_DIR, name))
        box = video.box
        with open(video.path, "rb") as f:
            samples = [box.sample(f, i) for i in range(len(box.sizes))]
        make = ((lambda b=box: msmpeg4.Decoder(b.codec, FULL_W, FULL_H,
                                               b.dsi))
                if codec in MSM_HOST else
                (lambda: h263.Decoder(sorenson=True)) if codec == "sorenson"
                else h263.Decoder)
        ms, got = host_decode(make, samples)
        host[codec] = {"decode_ms": ms, "convert_ms": convert_ms(got),
                       "bytes_a_frame": sum(map(len, samples)) / len(samples),
                       "frames": len(samples)}
    log("[27] (d) host ms a " + f"{FULL_H}x{FULL_W}" + " frame on one "
        "thread (decode, convert to BGR): " + "; ".join(
            f"{k} {v['decode_ms']!r} + {v['convert_ms']!r} "
            f"({v['bytes_a_frame']:.0f} bytes a frame, {v['frames']} frames)"
            for k, v in host.items()) + f"; {card}")

    # (e) what the port imported
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"
    phase_s = time.perf_counter() - t_phase
    log(f"[27] (e) cv2, PIL, jax not imported; phase 27 took {phase_s:.1f} "
        f"s; {card}")
    return {"fixtures": len(new), "frames": n_frames, "seeks": n_seeks,
            "refused": refused, "features": features,
            "unreached": unreached, "cli": row, "host_decode": host,
            "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


# phase 28: Snow in AVI, Matroska, QuickTime and ASF
SNOW_CLIP = "snow_sintel_436x1024.avi"   # cv2's writer, 13 frames
SNOW_FRAMES = 13
SNOW_MEMC = "snow_lavc_memc_only_64x48.avi"   # FFmpeg refuses its frames


def phase_snow(sd, tmp, corr_fwd, corr_bwd, card: str):
    """Snow through the port's entry points on the card machine (host C++
    ``runtime/snow.cpp`` behind the AVI, Matroska, QuickTime and ASF
    demuxers): (a) every fixture of the ``snow`` group equals cv2's
    digests, fps, size and count, each recorded seek reads cv2's frame, the
    crafted headers of what is left out raise naming item 8, and the
    ``memc_only`` stream, of which cv2 reads no frame, raises; (b) the
    video CLI over the 436x1024 Snow AVI, K1 on the card, bf16; (c) the
    pseudo regime over the same AVI (K1 and B1); (d) host ms to decode and
    to convert a 436x1024 Snow frame, beside MS-MPEG4 v3 and H.263+; (e)
    no cv2, PIL or jax imported.  Returns its results, each path's K1 (and
    B1) launches among them."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.runtime import h263, msmpeg4, snow

    t_phase = time.perf_counter()
    launches = {}

    # (a) the fixtures
    t0 = time.perf_counter()
    manifest = video_manifest()
    new = fixtures_of(manifest, "snow")
    memc = new.pop(SNOW_MEMC)
    assert memc["decoded"] == 0 and "port_refuses" in memc, memc
    try:
        list(vio.read_frames(os.path.join(MP4_DIR, SNOW_MEMC)))
    except ValueError as e:
        assert "block tree" in str(e), str(e)
    else:
        raise AssertionError(f"{SNOW_MEMC} was read")
    checked = check_fixtures(new)
    assert not checked["seeks_none"], checked
    refused = checked["refused"]
    # the crafted colour spaces and chroma shifts FFmpeg refuses (cv2 reads
    # no frame); every other crafted header decodes (phase 30)
    assert refused == sorted(n for n in new if n.startswith("snow_craft_")
                             and new[n]["decoded"] == 0), refused
    n_frames, n_seeks = checked["frames"], checked["seeks"]
    features = sorted({f for w in new.values()
                       for f in w.get("snow_features", [])})
    unreached = [f for f in snow.FEATURES if f not in features]
    assert unreached == manifest["snow_unreached"], unreached
    log(f"[28] (a) {len(new)} fixtures (SNOW in .avi/.mkv/.mov/.wmv; "
        f"libavcodec's tools, pixel formats and quantisers) decoded to "
        f"cv2.VideoCapture's {n_frames} frame digests and its "
        f"fps/size/count, {n_seeks} seeks to the frames cv2's read in "
        f"{time.perf_counter() - t0:.2f} s; crafted headers refused: "
        f"{len(refused)}; memc_only refused as FFmpeg refuses it; features "
        f"reached {len(features)} of {len(snow.FEATURES)} (none of the "
        f"fixtures: {unreached}); {card}")

    # (b) the video CLI over the 436x1024 Snow AVI
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    clip = os.path.join(MP4_DIR, SNOW_CLIP)
    k0 = corr_fwd.launches
    row = video_cli([clip, os.path.join(tmp, "out_snow.y4m"), "--ckpt", ckpt,
                     "--mode", "arrows", "--batch", str(VIDEO_B),
                     "--dtype", "bfloat16", "--device", "cuda"],
                    SNOW_FRAMES, FULL_H, FULL_W)
    row["k1_launches"] = launched = corr_fwd.launches - k0
    windows = row.pop("windows")
    assert windows == -(-(SNOW_FRAMES - 1) // VIDEO_B), windows
    assert launched == 5 * windows == 15, (launched, windows)
    del row["runner"], row["bytes_uploaded"]
    launches["cli"] = launched
    log(f"[28] (b) extract_video --mode arrows B={VIDEO_B} bf16, Snow .avi "
        f"({SNOW_FRAMES} frames {FULL_H}x{FULL_W}): {row['fps']!r} fps over "
        f"the run ({row['run_s']!r} s, fill {row['fill_s']:.2f} s); decode "
        f"thread busy {row['decode_ms']!r} ms a frame "
        f"({row['decode_share']:.1%}); {windows} windows, K1 {launched} "
        f"launches; {card}")

    # (c) the pseudo regime over the AVI (pairs read in any order: seeks)
    out_dir = os.path.join(tmp, "snow_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", clip, "--pretrained", ckpt,
        "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (SNOW_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert [r["step"] for r in recs] == list(range(1, steps + 1)), recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[28] (c) cli/train --regime pseudo over the Snow .avi "
        f"({SNOW_FRAMES} frames {FULL_H}x{FULL_W} -> 384x512), {steps} "
        f"steps at batch {TRAIN_B}: losses {[r['loss'] for r in recs]}; "
        f"K1/B1 launches {launches['pseudo']} (5 and 5 a step); "
        f"{wall_t:.2f} s wall; {card}")

    # (d) host ms a 436x1024 frame on one thread: decode, then convert to
    # BGR; Snow beside MS-MPEG4 v3 and H.263+ of the same pair
    host = {}
    for codec, name in (("snow", SNOW_CLIP),
                        ("msmpeg4v3", MSM_HOST["msmpeg4v3"]),
                        ("h263p", PLUS_CLIP)):
        video = vio.EncodedVideo(os.path.join(MP4_DIR, name))
        box = video.box
        with open(video.path, "rb") as f:
            samples = [box.sample(f, i) for i in range(len(box.sizes))]
        make = ((lambda: snow.Decoder(FULL_W, FULL_H)) if codec == "snow"
                else (lambda b=box: msmpeg4.Decoder(b.codec, FULL_W, FULL_H,
                                                    b.dsi))
                if codec == "msmpeg4v3" else h263.Decoder)
        ms, got = host_decode(make, samples)
        host[codec] = {"decode_ms": ms, "convert_ms": convert_ms(got),
                       "bytes_a_frame": sum(map(len, samples)) / len(samples),
                       "frames": len(samples)}
    log("[28] (d) host ms a " + f"{FULL_H}x{FULL_W}" + " frame on one "
        "thread (decode, convert to BGR): " + "; ".join(
            f"{k} {v['decode_ms']!r} + {v['convert_ms']!r} "
            f"({v['bytes_a_frame']:.0f} bytes a frame, {v['frames']} frames)"
            for k, v in host.items()) + f"; {card}")

    # (e) what the port imported
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"
    phase_s = time.perf_counter() - t_phase
    log(f"[28] (e) cv2, PIL, jax not imported; phase 28 took {phase_s:.1f} "
        f"s; {card}")
    return {"fixtures": len(new) + 1, "frames": n_frames, "seeks": n_seeks,
            "refused": refused + [SNOW_MEMC], "features": features,
            "unreached": unreached, "cli": row, "host_decode": host,
            "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


DIRAC_CLIP = "dirac_sintel_436x1024.nut"   # cv2's writer, 13 frames
DIRAC_FRAMES = 13
# what the port refuses with ValueError, as FFmpeg refuses it: a main
# header that fails its checksum (cv2 opens nothing), field coding (cv2
# reads no frame)
NUT_DIRAC_INVALID = {"nut_craft_badmain_96x64.nut": "main header",
                     "dirac_lavc_interlaced_64x48.avi": "field coding"}
# a P-VOP cut short (FFmpeg's guess_mv search conceals it)
PVOP_CUT = "nut_craft_truncated_pvop_96x64.nut"


def phase_nut_dirac(sd, tmp, corr_fwd, corr_bwd, card: str):
    """NUT and Dirac/VC-2 through the port's entry points on the card
    machine (``io/nut.py``; host C++ ``runtime/dirac.cpp`` behind it and
    the .drc, AVI, ASF, Matroska, QuickTime/MP4 and transport stream
    demuxers): (a) every fixture of the ``nut`` and ``dirac`` groups
    equals cv2's digests, fps, size and count, each recorded seek reads
    cv2's frame or, where cv2's reads nothing, raises, and what cv2
    refuses or the port leaves out raises; (b) the video CLI over the
    436x1024 VC-2 .nut, K1 on the card, bf16; (c) the pseudo regime over
    its packets remuxed into AVI by the port's muxer (K1 and B1): the .nut
    flags no key frame, so no seek in it reads a frame, in cv2 either;
    (d) host ms to decode and to convert a 436x1024 VC-2 frame, beside
    Snow and MS-MPEG4 v3, and NUT's demux ms a packet beside AVI's; (e) no
    cv2, PIL or jax imported.  Returns its results, each path's K1 (and
    B1) launches among them."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.io.avi import AviFile, AviWriter
    from opticalflow_tpu_torch.io.nut import FEATURES as NUT_FEATURES
    from opticalflow_tpu_torch.io.nut import NutFile
    from opticalflow_tpu_torch.runtime import dirac, msmpeg4, snow
    from opticalflow_tpu_torch.runtime.mpeg4 import i420_to_bgr

    t_phase = time.perf_counter()
    launches = {}

    # (a) the fixtures
    t0 = time.perf_counter()
    manifest = video_manifest()
    new = fixtures_of(manifest, "nut", "dirac")
    for name, what in NUT_DIRAC_INVALID.items():
        want = new.pop(name)
        assert want["decoded"] == 0 and what in want["port_refuses"], want
        try:
            list(vio.read_frames(os.path.join(MP4_DIR, name)))
        except ValueError as e:
            assert what in str(e), str(e)
        else:
            raise AssertionError(f"{name} was read")
    checked = check_fixtures(new)
    refused = checked["refused"]
    # a P-VOP cut short reads cv2's 24 frames, the concealed one included
    assert refused == [], refused
    assert new[PVOP_CUT]["decoded"] == 24 and "port_refuses" not in \
        new[PVOP_CUT]
    # a Dirac .nut: cv2's read after every seek finds nothing
    assert checked["seeks_none"] == 25 + DIRAC_FRAMES, checked
    n_frames, n_seeks = checked["frames"], checked["seeks"]
    reached = {}
    for key, names in (("dirac", dirac.FEATURES), ("nut", NUT_FEATURES)):
        got = {f for w in new.values() for f in w.get(f"{key}_features", [])}
        reached[key] = [f for f in names if f in got]
        unreached = [f for f in names if f not in got]
        assert unreached == manifest[f"{key}_unreached"], (key, unreached)
    log(f"[29] (a) {len(new)} fixtures (every fourcc in .nut, cut and "
        f"damaged .nut; drac in .drc/.avi/.mkv/.mov/.mp4/.ts/.nut/.wmv, "
        f"libavcodec's vc2 settings) decoded to cv2.VideoCapture's "
        f"{n_frames} frame digests and its fps/size/count, {n_seeks} seeks "
        f"to the frames cv2's read ({checked['seeks_none']} reading none, as "
        f"cv2's) in {time.perf_counter() - t0:.2f} s; refused: "
        f"{refused + sorted(NUT_DIRAC_INVALID)}; Dirac features "
        f"{len(reached['dirac'])} of {len(dirac.FEATURES)}, NUT's "
        f"{len(reached['nut'])} of {len(NUT_FEATURES)}; {card}")

    # (b) the video CLI over the 436x1024 VC-2 .nut
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    clip = os.path.join(MP4_DIR, DIRAC_CLIP)
    k0 = corr_fwd.launches
    row = video_cli([clip, os.path.join(tmp, "out_dirac.y4m"), "--ckpt",
                     ckpt, "--mode", "arrows", "--batch", str(VIDEO_B),
                     "--dtype", "bfloat16", "--device", "cuda"],
                    DIRAC_FRAMES, FULL_H, FULL_W)
    row["k1_launches"] = launched = corr_fwd.launches - k0
    windows = row.pop("windows")
    assert windows == -(-(DIRAC_FRAMES - 1) // VIDEO_B), windows
    assert launched == 5 * windows == 15, (launched, windows)
    del row["runner"], row["bytes_uploaded"]
    launches["cli"] = launched
    log(f"[29] (b) extract_video --mode arrows B={VIDEO_B} bf16, VC-2 .nut "
        f"({DIRAC_FRAMES} frames {FULL_H}x{FULL_W}): {row['fps']!r} fps "
        f"over the run ({row['run_s']!r} s, fill {row['fill_s']:.2f} s); "
        f"decode thread busy {row['decode_ms']!r} ms a frame "
        f"({row['decode_share']:.1%}); {windows} windows, K1 {launched} "
        f"launches; {card}")

    # (c) the pseudo regime over the same packets in AVI (pairs read in any
    # order: seeks, which read nothing in the .nut)
    nut = vio.EncodedVideo(clip)
    assert nut.seek_target(3) is None
    avi = os.path.join(tmp, "dirac_sintel_436x1024.avi")
    mux = AviWriter(avi, (FULL_W, FULL_H), (25, 1), fourcc="drac")
    with open(clip, "rb") as f:
        packets = [nut.box.sample(f, i) for i in range(nut.samples)]
    for data in packets:
        mux.write(data, True)
    mux.release()
    assert [pixel_digest(fr) for fr in vio.read_frames(avi)] == \
        manifest["files"][DIRAC_CLIP]["sha256"]
    out_dir = os.path.join(tmp, "dirac_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", avi, "--pretrained", ckpt,
        "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (DIRAC_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert [r["step"] for r in recs] == list(range(1, steps + 1)), recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[29] (c) cli/train --regime pseudo over the VC-2 packets in AVI "
        f"({DIRAC_FRAMES} frames {FULL_H}x{FULL_W} -> 384x512), {steps} "
        f"steps at batch {TRAIN_B}: losses {[r['loss'] for r in recs]}; "
        f"K1/B1 launches {launches['pseudo']} (5 and 5 a step); "
        f"{wall_t:.2f} s wall; {card}")

    # (d) host ms a 436x1024 frame on one thread: decode, then convert to
    # BGR (VC-2 at BT.709, as its sequence header names); VC-2 beside Snow
    # and MS-MPEG4 v3 of the same pair; then a packet's demux, NUT and AVI
    host = {}
    for codec, name in (("dirac", DIRAC_CLIP), ("snow", SNOW_CLIP),
                        ("msmpeg4v3", MSM_HOST["msmpeg4v3"])):
        video = vio.EncodedVideo(os.path.join(MP4_DIR, name))
        box = video.box
        with open(video.path, "rb") as f:
            samples = [box.sample(f, i) for i in range(len(box.sizes))]
        make = (dirac.Decoder if codec == "dirac" else
                (lambda: snow.Decoder(FULL_W, FULL_H)) if codec == "snow"
                else (lambda b=box: msmpeg4.Decoder(b.codec, FULL_W, FULL_H,
                                                    b.dsi)))
        ms, got = host_decode(make, samples)
        if codec == "dirac":
            t0 = time.perf_counter()
            for _ in range(HOST_TIMED):
                for p in got:
                    i420_to_bgr(*p, matrix="bt709")
            cms = (time.perf_counter() - t0) / HOST_TIMED / len(got) * 1e3
        else:
            cms = convert_ms(got)
        host[codec] = {"decode_ms": ms, "convert_ms": cms,
                       "bytes_a_frame": sum(map(len, samples)) / len(samples),
                       "frames": len(samples)}
    demux = {}
    for kind, path, opener in (("nut", clip, NutFile), ("avi", avi, AviFile)):
        t0 = time.perf_counter()
        for _ in range(HOST_TIMED):
            box = opener(path)
            with open(path, "rb") as f:
                got = [box.sample(f, i) for i in range(len(box.sizes))]
        demux[kind] = (time.perf_counter() - t0) / HOST_TIMED / len(got) * 1e3
        assert got == packets, kind
    log("[29] (d) host ms a " + f"{FULL_H}x{FULL_W}" + " frame on one "
        "thread (decode, convert to BGR): " + "; ".join(
            f"{k} {v['decode_ms']!r} + {v['convert_ms']!r} "
            f"({v['bytes_a_frame']:.0f} bytes a frame, {v['frames']} frames)"
            for k, v in host.items()) + "; demux (open, parse, read) a "
        f"packet: NUT {demux['nut']!r} ms, AVI {demux['avi']!r} ms; {card}")

    # (e) what the port imported
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"
    phase_s = time.perf_counter() - t_phase
    log(f"[29] (e) cv2, PIL, jax not imported; phase 29 took {phase_s:.1f} "
        f"s; {card}")
    return {"fixtures": len(new) + len(NUT_DIRAC_INVALID),
            "frames": n_frames, "seeks": n_seeks,
            "seeks_none": checked["seeks_none"],
            "refused": refused + sorted(NUT_DIRAC_INVALID),
            "features": reached, "cli": row, "host_decode": host,
            "demux_ms": demux, "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


# ------------------------------------------------------------ phase 30

# the fixtures the port once refused and cv2 reads (a P-VOP cut short
# among them: FFmpeg's guess_mv search conceals it)
REPAIRED = ["dirac_lavc_yuv420p10_64x48.avi", "nut_craft_truncated_96x64.nut",
            *(f"snow_craft_{n}_64x48.avi" for n in (
                "always_reset", "temporal_type", "temporal_count",
                "scalability", "htaps4", "diag_mc0")), PVOP_CUT]
# the fixtures that hold those repairs further: VC-2 at 10 and 12 bits
# with every bit used, Snow's MC filters on non-zero vectors
DEEP_AND_TEXTURED = [
    *(f"dirac_lavc_{p}_fine_64x48.avi" for p in (
        "yuv420p10", "yuv422p10", "yuv444p10", "yuv420p12")),
    "dirac_lavc_yuv444p10_53x37.avi",
    *(f"snow_craft_textured_{f}_64x48.avi" for f in (
        "default", "htaps4", "htaps6", "diag_mc0"))]
# every extension cv2's mp4v writer opens beyond .mp4, .avi and .mkv
NEW_CONTAINERS = (".mov", ".m4v", ".3gp", ".3g2", ".nut", ".wmv", ".asf",
                  ".mpg", ".mpeg", ".vob", ".ts", ".mts", ".m2t", ".m2ts")


def phase_containers(sd, tmp, corr_fwd, card: str, mp4_rows: dict):
    """The writer's containers and the repaired fixtures on the card machine
    (``AsyncVideoWriter`` into ``io/mp4``, ``io/nut``, ``io/asf``,
    ``io/mpegps`` and ``io/mpegts``): (a) the repaired and new fixtures
    against cv2's digests and seeks (a P-VOP cut short reads cv2's 24
    frames); the 436x1024 Sintel clip through ``AsyncVideoWriter`` into each
    new container, read back by the port's reader to the encoder's
    reconstruction; the encode and each container's mux timed apart (host
    ms a frame, one thread); no cv2, PIL or jax imported; (b) the video
    CLI over that clip into .mov and .ts, K1 on the card, bf16, beside
    phase 17's .mp4 run.  Returns its results, each CLI run's K1 launches
    among them."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.runtime.mpeg4 import Encoder, i420_to_bgr
    from opticalflow_tpu_torch.io.yuv import i420_planes

    t_phase = time.perf_counter()
    launches = {}

    # (a) the repaired fixtures and those that hold the repairs
    t0 = time.perf_counter()
    manifest = video_manifest()
    fixtures = {n: manifest["files"][n] for n in REPAIRED + DEEP_AND_TEXTURED}
    assert not any("port_refuses" in fixtures[n] for n in REPAIRED)
    checked = check_fixtures(fixtures)
    assert checked["refused"] == [], checked
    assert len(list(vio.read_frames(os.path.join(MP4_DIR, PVOP_CUT)))) == 24
    log(f"[30] (a) {len(fixtures)} fixtures (the {len(REPAIRED)} the port "
        f"refused and cv2 reads: 10-bit VC-2, an I-VOP and a P-VOP cut "
        f"short in .nut, Snow's always_reset, temporal fields, scalability "
        f"and MC filters; VC-2 at 10/12 bits 4:2:0/4:2:2/4:4:4, Snow's "
        f"filters on non-zero vectors) decoded to cv2.VideoCapture's "
        f"{checked['frames']} frame digests and its fps/size/count, "
        f"{checked['seeks']} seeks to the frames cv2's read, in "
        f"{time.perf_counter() - t0:.2f} s; refused: {checked['refused']}; "
        f"{card}")

    # the clip, its reconstruction, and the encode alone
    clip = os.path.join(MP4_DIR, DIRAC_CLIP)
    frames = list(vio.read_frames(clip))
    assert len(frames) == DIRAC_FRAMES
    size = (FULL_W, FULL_H)
    ref = vio.Mpeg4Writer(os.path.join(tmp, "recon.mp4"), 25.0, size,
                          keep_recon=True)
    for fr in frames:
        ref.write(fr)
    ref.release()
    recon = [i420_to_bgr(*r) for r in ref.recon]
    encoded, encode_ms = {}, {}
    for inband in (False, True):
        t0 = time.perf_counter()
        enc = Encoder(FULL_W, FULL_H, 25, 1, inband=inband)
        out = [enc.encode(*i420_planes(vio.to_i420(fr))) for fr in frames]
        encode_ms["inband" if inband else "global"] = \
            (time.perf_counter() - t0) / len(frames) * 1e3
        encoded[inband] = (out, enc.headers)
    rows = {}
    for ext in NEW_CONTAINERS:
        path = os.path.join(tmp, f"sintel{ext}")
        t0 = time.perf_counter()
        wr = vio.AsyncVideoWriter(path, 25.0, size)
        for fr in frames:
            wr.write(fr)
        wr.release()
        write_ms = (time.perf_counter() - t0) / len(frames) * 1e3
        got = list(vio.read_frames(path))
        assert len(got) == len(recon), (ext, len(got))
        for k, (a, b) in enumerate(zip(got, recon)):
            assert np.array_equal(a, b), (ext, k)
        info = vio.video_info(path)
        assert (info["width"], info["height"]) == size, (ext, info)
        # the mux alone, over the pictures encoded above
        kind = vio._kind(path, writing=True)
        samples, headers = encoded[kind in vio._INBAND]
        rate = vio._opencv_rate(25.0) if kind == "mpg" else vio._rate(25.0)
        mux_path = os.path.join(tmp, f"mux{ext}")
        t0 = time.perf_counter()
        for _ in range(HOST_TIMED):
            mux = vio._muxer(mux_path, kind, size, rate, headers)
            for sample, key in samples:
                mux.write(sample, key)
            mux.release()
        mux_ms = (time.perf_counter() - t0) / HOST_TIMED / len(frames) * 1e3
        with open(path, "rb") as a, open(mux_path, "rb") as b:
            assert a.read() == b.read(), ext
        rows[ext] = {"mux_ms": mux_ms, "writer_ms": write_ms,
                     "bytes": os.path.getsize(path),
                     "frames_reported": info["frames"], "fps": info["fps"]}
    log(f"[30] (a) {len(NEW_CONTAINERS)} containers, the {DIRAC_FRAMES}-frame "
        f"{FULL_H}x{FULL_W} clip through AsyncVideoWriter, read back to the "
        f"encoder's reconstruction; host ms a frame, one thread: encode "
        f"{encode_ms['global']!r} (VOL in the header), {encode_ms['inband']!r}"
        f" (VOL in band); mux " + ", ".join(
            f"{e} {r['mux_ms']!r}" for e, r in rows.items()) + f"; {card}")
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"

    # (b) the video CLI over the clip into .mov and .ts
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    cli_rows = {}
    for ext in (".mov", ".ts"):
        out = os.path.join(tmp, f"out_sintel{ext}")
        k0 = corr_fwd.launches
        row = video_cli([clip, out, "--ckpt", ckpt, "--mode", "arrows",
                         "--batch", str(VIDEO_B), "--dtype", "bfloat16",
                         "--device", "cuda"], DIRAC_FRAMES, FULL_H, FULL_W)
        row["k1_launches"] = launched = corr_fwd.launches - k0
        windows = row.pop("windows")
        assert windows == -(-(DIRAC_FRAMES - 1) // VIDEO_B), windows
        assert launched == 5 * windows == 15, (launched, windows)
        del row["runner"], row["bytes_uploaded"]
        back = list(vio.read_frames(out))
        assert len(back) == DIRAC_FRAMES - 1 and all(
            f.shape == (FULL_H, FULL_W, 3) for f in back), len(back)
        cli_rows[ext] = row
        launches[ext] = launched
        mp4 = mp4_rows["mp4"]
        log(f"[30] (b) extract_video --mode arrows B={VIDEO_B} bf16 into "
            f"{ext} ({DIRAC_FRAMES} frames {FULL_H}x{FULL_W}): {row['fps']!r}"
            f" fps over the run ({row['run_s']!r} s), encode thread busy "
            f"{row['encode_ms']!r} ms a frame ({row['encode_share']:.1%}); "
            f"phase 17's .mp4 ({VIDEO_H}x{VIDEO_W}): {mp4['fps']!r} fps, "
            f"encode {mp4['encode_ms']!r} ms a frame; {windows} windows, K1 "
            f"{launched} launches; read back {len(back)} frames; {card}")
    phase_s = time.perf_counter() - t_phase
    log(f"[30] phase 30 took {phase_s:.1f} s; {card}")
    return {"fixtures": len(fixtures), "frames": checked["frames"],
            "seeks": checked["seeks"], "refused": checked["refused"],
            "encode_ms": encode_ms, "containers": rows, "cli": cli_rows,
            "launches": launches, "phase_s": phase_s, "card": card}


# ------------------------------------------------------------ phase 31

J2K_CLIP = "j2k_sintel_436x1024.avi"   # cv2's writer (MJ2C), 5 frames
J2K_FRAMES = 5
PSEUDO_FRAMES = 13                    # its packets cycled, for 3 steps


def phase_jpeg2000(sd, tmp, corr_fwd, corr_bwd, card: str):
    """JPEG 2000, the tags and raw layouts cv2's writer uses, and P-VOPs cut
    short, through the port's entry points on the card machine (host C++
    ``runtime/jpeg2000.cpp`` and ``runtime/mpeg4.cpp``'s error
    concealment behind ``io/video.py`` and the AVI, Matroska,
    QuickTime/MP4, NUT and ASF demuxers): (a) every fixture of the
    ``jpeg2000``, ``tag`` and ``cut_vop`` groups equals cv2's digests, fps,
    size and count, and each recorded seek reads cv2's frame; the cut
    P-VOP of phase 29 reads cv2's 24 frames; the decoder's features
    against the manifest's unreached list; (b) the video CLI over the
    436x1024 JPEG 2000 AVI, K1 on the card, bf16; (c) the pseudo regime
    over its packets cycled to 13 frames in AVI, 3 steps (K1 and B1); (d)
    host ms to decode a 436x1024 JPEG 2000 frame, split into tier 1 (with
    the dequantisation), the inverse DWT and the output, and swscale's
    conversion, beside phase 29's VC-2; (e) no cv2, PIL or jax imported.
    Returns its results, each path's K1 (and B1) launches among them."""
    import numpy as np
    import torch
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.io.avi import AviWriter
    from opticalflow_tpu_torch.runtime import dirac, jpeg2000
    from opticalflow_tpu_torch.runtime.mpeg4 import i420_to_bgr

    t_phase = time.perf_counter()
    launches = {}

    # (a) the fixtures
    t0 = time.perf_counter()
    manifest = video_manifest()
    new = fixtures_of(manifest, "jpeg2000", "tag", "cut_vop")
    groups = {g: sum(w["group"] == g for w in new.values())
              for g in ("jpeg2000", "tag", "cut_vop")}
    assert all(groups.values()), groups
    checked = check_fixtures(new)
    assert checked["refused"] == [], checked
    assert len(list(vio.read_frames(os.path.join(MP4_DIR, PVOP_CUT)))) == 24
    got = {f for n, w in new.items() for f in w.get("jpeg2000_features", [])}
    unreached = [f for f in jpeg2000.FEATURES if f not in got]
    assert unreached == manifest["jpeg2000_unreached"], unreached
    paths = {n: w["mpeg4_concealment"] for n, w in new.items()
             if "mpeg4_concealment" in w}
    assert any(c["searched"] for c in paths.values()) and any(
        c["spatial"] for c in paths.values()), paths
    log(f"[31] (a) {len(new)} fixtures ({groups['jpeg2000']} JPEG 2000: "
        f"cv2's writer in .avi/.mkv/.mov/.mp4/.nut/.wmv at 96x64 and 52x36, "
        f"libavcodec's 5/3, progression orders, tiles, SOP/EPH, layers, "
        f"codestreams, every layout the encoder writes (8-16 bits, alpha, "
        f"palettes), crafted ICT, RCT, POC/COC/QCC, tile-parts; "
        f"{groups['tag']} tags and raw layouts; "
        f"{groups['cut_vop']} VOPs cut short: guess_mv's search and the "
        f"spatial path) decoded to cv2.VideoCapture's {checked['frames']} "
        f"frame digests and its fps/size/count, {checked['seeks']} seeks to "
        f"the frames cv2's read, in {time.perf_counter() - t0:.2f} s; the cut "
        f"P-VOP of phase 29 reads 24 frames; JPEG 2000 features "
        f"{len(jpeg2000.FEATURES) - len(unreached)} of "
        f"{len(jpeg2000.FEATURES)}; {card}")

    # (b) the video CLI over the 436x1024 JPEG 2000 AVI
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    clip = os.path.join(MP4_DIR, J2K_CLIP)
    k0 = corr_fwd.launches
    row = video_cli([clip, os.path.join(tmp, "out_j2k.y4m"), "--ckpt",
                     ckpt, "--mode", "arrows", "--batch", str(VIDEO_B),
                     "--dtype", "bfloat16", "--device", "cuda"],
                    J2K_FRAMES, FULL_H, FULL_W)
    row["k1_launches"] = launched = corr_fwd.launches - k0
    windows = row.pop("windows")
    assert windows == -(-(J2K_FRAMES - 1) // VIDEO_B) == 1, windows
    assert launched == 5 * windows, (launched, windows)
    del row["runner"], row["bytes_uploaded"]
    launches["cli"] = launched
    log(f"[31] (b) extract_video --mode arrows B={VIDEO_B} bf16, JPEG 2000 "
        f".avi ({J2K_FRAMES} frames {FULL_H}x{FULL_W}): {row['fps']!r} fps "
        f"over the run ({row['run_s']!r} s, fill {row['fill_s']:.2f} s); "
        f"decode thread busy {row['decode_ms']!r} ms a frame "
        f"({row['decode_share']:.1%}); {windows} window, K1 {launched} "
        f"launches; {card}")

    # (c) the pseudo regime over the clip's packets cycled to 13 frames
    video = vio.EncodedVideo(clip)
    with open(clip, "rb") as f:
        packets = [video.box.sample(f, i) for i in range(video.samples)]
    avi = os.path.join(tmp, "j2k_sintel_13.avi")
    mux = AviWriter(avi, (FULL_W, FULL_H), (25, 1), fourcc="MJ2C")
    for i in range(PSEUDO_FRAMES):
        mux.write(packets[i % J2K_FRAMES], True)
    mux.release()
    want = manifest["files"][J2K_CLIP]["sha256"]
    assert [pixel_digest(fr) for fr in vio.read_frames(avi)] == [
        want[i % J2K_FRAMES] for i in range(PSEUDO_FRAMES)]
    out_dir = os.path.join(tmp, "j2k_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", avi, "--pretrained", ckpt,
        "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (PSEUDO_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert steps == 3 and [r["step"] for r in recs] == [1, 2, 3], recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[31] (c) cli/train --regime pseudo over the JPEG 2000 packets "
        f"cycled to {PSEUDO_FRAMES} frames in AVI ({FULL_H}x{FULL_W} -> "
        f"384x512), {steps} steps at batch {TRAIN_B}: losses "
        f"{[r['loss'] for r in recs]}; K1/B1 launches {launches['pseudo']} "
        f"(5 and 5 a step); {wall_t:.2f} s wall; {card}")

    # (d) host ms a 436x1024 frame on one thread: JPEG 2000's decode split
    # by stage, its conversion (yuv420p, swscale's x86 yuv2rgb), beside
    # VC-2's
    dec = jpeg2000.Decoder()
    dec.decode(packets[0])
    base = dec.times
    t0 = time.perf_counter()
    for _ in range(HOST_TIMED):
        planes = [dec.decode(p) for p in packets]
    j2k_ms = (time.perf_counter() - t0) / HOST_TIMED / len(packets) * 1e3
    stage = [(b - a) / HOST_TIMED / len(packets)
             for a, b in zip(base, dec.times)]
    assert dec.layout == "yuv420p", dec.layout
    assert [pixel_digest(i420_to_bgr(*p)) for p in planes] == want
    host = {"jpeg2000": {"decode_ms": j2k_ms, "tier1_ms": stage[0],
                         "dwt_ms": stage[1], "output_ms": stage[2],
                         "convert_ms": convert_ms(planes),
                         "bytes_a_frame": sum(map(len, packets))
                         / len(packets), "frames": len(packets)}}
    nut = vio.EncodedVideo(os.path.join(MP4_DIR, DIRAC_CLIP))
    with open(nut.path, "rb") as f:
        samples = [nut.box.sample(f, i) for i in range(nut.samples)]
    ms, got = host_decode(dirac.Decoder, samples)
    t0 = time.perf_counter()
    for _ in range(HOST_TIMED):
        for p in got:
            i420_to_bgr(*p, matrix="bt709")
    host["dirac"] = {"decode_ms": ms, "convert_ms": (
        time.perf_counter() - t0) / HOST_TIMED / len(got) * 1e3,
        "bytes_a_frame": sum(map(len, samples)) / len(samples),
        "frames": len(samples)}
    j = host["jpeg2000"]
    log(f"[31] (d) host ms a {FULL_H}x{FULL_W} frame on one thread: JPEG "
        f"2000 decode {j['decode_ms']!r} (tier 1 and dequantisation "
        f"{j['tier1_ms']!r}, inverse 9/7 DWT {j['dwt_ms']!r}, level shift "
        f"and output {j['output_ms']!r}) + convert {j['convert_ms']!r} "
        f"({j['bytes_a_frame']:.0f} bytes a frame); VC-2 "
        f"{host['dirac']['decode_ms']!r} + {host['dirac']['convert_ms']!r} "
        f"({host['dirac']['bytes_a_frame']:.0f} bytes a frame); {card}")

    # (e) what the port imported
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"
    phase_s = time.perf_counter() - t_phase
    log(f"[31] (e) cv2, PIL, jax not imported; phase 31 took {phase_s:.1f} "
        f"s; {card}")
    return {"fixtures": len(new), "groups": groups,
            "frames": checked["frames"], "seeks": checked["seeks"],
            "unreached": unreached, "concealment": paths, "cli": row,
            "host_decode": host,
            "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


# ------------------------------------------------------------ phase 32

H264_FRAMES = 13                      # the CLI clip: IDR then 12 P
H264_PAN = (12, -6)                   # its global vector (quarter samples)


def real_im1_planes():
    """``tests/goldens/real_im1.png`` nearest-neighbour scaled to 436x1024,
    as the I420 planes of 448 coded rows (edge-padded)."""
    import numpy as np
    from opticalflow_tpu_torch.io.images import load_image
    from opticalflow_tpu_torch.io.yuv import i420_planes
    from opticalflow_tpu_torch.runtime.mpeg4 import to_i420
    img = load_image(os.path.join(GOLD, "real_im1.png"))
    rgb = img[np.arange(FULL_H) * img.shape[0] // FULL_H][
        :, np.arange(FULL_W) * img.shape[1] // FULL_W]
    y, u, v = i420_planes(to_i420(np.ascontiguousarray(rgb[..., ::-1])))
    pad = 448 - FULL_H
    return (np.pad(y, ((0, pad), (0, 0)), mode="edge"),
            np.pad(u, ((0, pad // 2), (0, 0)), mode="edge"),
            np.pad(v, ((0, pad // 2), (0, 0)), mode="edge"))


def h264_clip(cabac: bool):
    """The 436x1024 H.264 clip the card run decodes, from the syntax
    writer (``tests/h264_syntax.py``): an IDR picture holding
    ``tests/goldens/real_im1.png`` (nearest-neighbour scaled to 436x1024)
    in I_PCM, then P pictures of P_L0_16x16
    macroblocks that all move by ``H264_PAN`` with no residual (a pan),
    High profile, coded 448 rows cropped to 436.  (SPS, PPS, access
    units, key flags)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import h264_syntax as hs
    planes = real_im1_planes()
    pad = 448 - FULL_H
    sps = [hs.Sps(profile=100, level=40, mb_w=FULL_W // 16, mb_h=28,
                  crop=(0, 0, 0, pad), max_num_ref_frames=1)]
    pps = [hs.Pps(cabac=cabac, transform_8x8=True)]
    pics = [hs.Pic(idr=True, mb_types=("PCM",), pcm=planes)] + [
        hs.Pic(kind="P", global_mv=H264_PAN)
        for _ in range(H264_FRAMES - 1)]
    aus = hs.write_stream(32, sps, pps, pics)
    return sps, pps, aus, [p.idr for p in pics]


def phase_h264(sd, tmp, corr_fwd, corr_bwd, card: str):
    """H.264 through the port's entry points on the card machine (host C++
    ``runtime/h264.cpp`` behind ``io/video.py`` and the MP4, QuickTime,
    Matroska, AVI, MPEG-TS, NUT, ASF and raw demuxers): (a) every fixture of
    the ``h264`` group (CAVLC and CABAC) equals cv2's digests, fps, size
    and count, each recorded seek reads cv2's frame, each picture's planes
    equal the digests of libavcodec's, the decoder's features against the
    manifest's unreached list; the VOP cut right after its start code reads
    cv2's 24 frames; (b) the video CLI over the 13-frame 436x1024 H.264
    .mp4 (``h264_clip``, CABAC), K1 on the card, bf16; (c) the pseudo
    regime over that .mp4, 3 steps (K1 and B1); (d) host ms to decode a
    436x1024 frame, I and P apart, CAVLC beside CABAC, for the CLI clip and
    for pictures of random intra and inter macroblocks, beside MPEG-4 Part
    2 on the same frames, and swscale's conversion; (e) no cv2, PIL or jax
    imported.  Returns its results, each path's K1 (and B1) launches among
    them."""
    import hashlib
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import h264_syntax as hs
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.io.nut import NutFile
    from opticalflow_tpu_torch.io.yuv import i420_planes
    from opticalflow_tpu_torch.runtime import h264, mpeg4
    from opticalflow_tpu_torch.runtime.mpeg4 import i420_to_bgr

    t_phase = time.perf_counter()
    launches = {}

    # (a) the fixtures, and the VOP cut right after its start code
    t0 = time.perf_counter()
    manifest = video_manifest()
    new = fixtures_of(manifest, "h264")
    coders = {c: sum(f"_{c}" in n for n in new) for c in ("cavlc", "cabac")}
    assert coders["cavlc"] == coders["cabac"] > 0, coders
    checked = check_fixtures(new)
    assert checked["refused"] == [], checked
    planes = 0
    for name, want in sorted(new.items()):
        video = vio.EncodedVideo(os.path.join(MP4_DIR, name))
        got = [hashlib.sha256(b"".join(np.ascontiguousarray(q).tobytes()
                                       for q in p)).hexdigest()
               for _, p in video.planes(0)]
        assert got == want["h264_planes"], name
        planes += len(got)
    reached = {f for w in new.values() for f in w["h264_features"]}
    unreached = [f for f in h264.FEATURES + h264.MODES if f not in reached]
    assert unreached == manifest["h264_unreached"], unreached
    src = os.path.join(MP4_DIR, "nut_mp4v_96x64.nut")
    data = open(src, "rb").read()
    pvop = [x for x in NutFile(src).frames_ if not x.key][-1]
    cut = os.path.join(tmp, "cut4.nut")
    with open(cut, "wb") as f:
        f.write(data[:pvop.offset + 4])
    cut_frames = len(list(vio.read_frames(cut)))
    assert cut_frames == 24, cut_frames
    log(f"[32] (a) {len(new)} fixtures ({coders['cavlc']} CAVLC, "
        f"{coders['cabac']} CABAC: the syntax writer's streams muxed by "
        f"libavformat into .mp4/.mov/.mkv/.avi/.ts/.h264/.nut/.wmv/.flv; "
        f"I_PCM, "
        f"every intra mode, every P partition, long-term references and "
        f"MMCO, weights, scaling lists, QP 0-51, deblocking modes, slices, "
        f"POC types 0-2, VUI, crops, a recovery point) decoded to "
        f"cv2.VideoCapture's {checked['frames']} frame digests and its "
        f"fps/size/count, {checked['seeks']} seeks to the frames cv2 read, "
        f"{planes} pictures' planes to libavcodec's, in "
        f"{time.perf_counter() - t0:.2f} s; features "
        f"{len(reached)} of {len(h264.FEATURES) + len(h264.MODES)} (the "
        f"rest no edge block can use); the VOP cut after its start code "
        f"reads {cut_frames} frames; {card}")

    # (b) the video CLI over the 436x1024 H.264 .mp4 (CABAC)
    t0 = time.perf_counter()
    sps, pps, aus, keys = h264_clip(True)
    clip = os.path.join(tmp, "h264_pan_436x1024.mp4")
    hs.write_mp4(clip, [hs.length_prefixed(a) for a in aus], keys,
                 hs.avcc(sps, pps), FULL_W, FULL_H)
    write_s = time.perf_counter() - t0
    shown = list(vio.read_frames(clip))
    assert len(shown) == H264_FRAMES and shown[0].shape == (FULL_H, FULL_W,
                                                             3)
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    k0 = corr_fwd.launches
    row = video_cli([clip, os.path.join(tmp, "out_h264.y4m"), "--ckpt",
                     ckpt, "--mode", "arrows", "--batch", str(VIDEO_B),
                     "--dtype", "bfloat16", "--device", "cuda"],
                    H264_FRAMES, FULL_H, FULL_W)
    row["k1_launches"] = launched = corr_fwd.launches - k0
    windows = row.pop("windows")
    assert windows == -(-(H264_FRAMES - 1) // VIDEO_B) == 3, windows
    assert launched == 5 * windows, (launched, windows)
    del row["runner"], row["bytes_uploaded"]
    launches["cli"] = launched
    log(f"[32] (b) extract_video --mode arrows B={VIDEO_B} bf16, H.264 CABAC "
        f".mp4 ({H264_FRAMES} frames {FULL_H}x{FULL_W}: real_im1 in I_PCM, "
        f"then a pan of {H264_PAN} quarter samples a frame; written in "
        f"{write_s:.2f} s): {row['fps']!r} fps over the run "
        f"({row['run_s']!r} s, fill {row['fill_s']:.2f} s); decode thread "
        f"busy {row['decode_ms']!r} ms a frame ({row['decode_share']:.1%}); "
        f"{windows} windows, K1 {launched} launches; {card}")

    # (c) the pseudo regime over the .mp4
    out_dir = os.path.join(tmp, "h264_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", clip, "--pretrained", ckpt,
        "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (H264_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert steps == 3 and [r["step"] for r in recs] == [1, 2, 3], recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[32] (c) cli/train --regime pseudo over the H.264 .mp4 "
        f"({FULL_H}x{FULL_W} -> 384x512), {steps} steps at batch {TRAIN_B}: "
        f"losses {[r['loss'] for r in recs]}; K1/B1 launches "
        f"{launches['pseudo']} (5 and 5 a step); {wall_t:.2f} s wall; "
        f"{card}")

    # (d) host ms a 436x1024 frame on one thread, I and P apart, CAVLC
    # beside CABAC: the CLI clip (I_PCM, then motion alone) and pictures of
    # random macroblocks (intra modes with residual; P partitions, skips
    # and intra), beside MPEG-4 Part 2 on the same frames
    def timed(units):
        d = h264.Decoder()
        [d.decode(u) for u in units]
        d.flush()
        per = [0.0] * len(units)
        for _ in range(HOST_TIMED):
            d = h264.Decoder()
            got = []
            for i, u in enumerate(units):
                t = time.perf_counter()
                got += d.decode(u)
                per[i] += time.perf_counter() - t
            got += d.flush()
        assert len(got) == len(units), (len(got), len(units))
        per = [p / HOST_TIMED * 1e3 for p in per]
        return per, got

    host = {}
    mixed_sps = [hs.Sps(profile=100, level=40, mb_w=FULL_W // 16, mb_h=28,
                        crop=(0, 0, 0, 448 - FULL_H), max_num_ref_frames=1)]
    mixed_pics = [hs.Pic(idr=True, mb_types=("I4", "I8", "I16"),
                         density=0.15),
                  hs.Pic(kind="P", mb_types=("P", "SKIP", "I4", "I16"),
                         density=0.1)]
    frames = None
    for cabac in (False, True):
        tag = "cabac" if cabac else "cavlc"
        cs, cp, caus, _ = h264_clip(cabac)
        per, _ = timed(caus)
        host[f"clip_{tag}"] = {"i_ms": per[0],
                               "p_ms": sum(per[1:]) / len(per[1:]),
                               "bytes_i": len(caus[0]),
                               "bytes_p": sum(map(len, caus[1:]))
                               / len(caus[1:])}
        maus = hs.write_stream(33, mixed_sps,
                               [hs.Pps(cabac=cabac, transform_8x8=True)],
                               mixed_pics)
        per, got = timed(maus)
        host[f"mixed_{tag}"] = {"i_ms": per[0], "p_ms": per[1],
                                "bytes_i": len(maus[0]),
                                "bytes_p": len(maus[1])}
        pics = [i420_to_bgr(*p) for p in got]
        if frames is None:
            frames = pics
        else:   # the same macroblocks in either coder
            assert all(np.array_equal(a, b) for a, b in zip(frames, pics))
    host["convert_ms"] = convert_ms(got)
    enc = mpeg4.Encoder(FULL_W, FULL_H, 25, 1)
    samples = [enc.encode(*i420_planes(mpeg4.to_i420(f)))[0] for f in frames]
    ms, _ = host_decode(lambda: mpeg4.Decoder(enc.headers), samples)
    host["mpeg4_ms"] = ms
    c, m = host["clip_cabac"], host["mixed_cabac"]
    log(f"[32] (d) host ms a {FULL_H}x{FULL_W} frame on one thread: CLI "
        f"clip I_PCM {host['clip_cavlc']['i_ms']!r} (CAVLC) / "
        f"{c['i_ms']!r} (CABAC), pan P {host['clip_cavlc']['p_ms']!r} / "
        f"{c['p_ms']!r}; random macroblocks I "
        f"{host['mixed_cavlc']['i_ms']!r} / {m['i_ms']!r} "
        f"({host['mixed_cavlc']['bytes_i']} / {m['bytes_i']} bytes), P "
        f"{host['mixed_cavlc']['p_ms']!r} / {m['p_ms']!r} "
        f"({host['mixed_cavlc']['bytes_p']} / {m['bytes_p']} bytes); "
        f"MPEG-4 Part 2 on the same frames {ms!r}; convert "
        f"{host['convert_ms']!r}; {card}")

    # (e) what the port imported
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"
    phase_s = time.perf_counter() - t_phase
    log(f"[32] (e) cv2, PIL, jax not imported; phase 32 took {phase_s:.1f} "
        f"s; {card}")
    return {"fixtures": len(new), "coders": coders,
            "frames": checked["frames"], "seeks": checked["seeks"],
            "planes": planes, "unreached": unreached,
            "cut_vop_frames": cut_frames, "cli": row, "host_decode": host,
            "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


H264_B_GOP = 3                        # the B clip: P every third frame


def h264_b_clip(cabac: bool, spatial: bool = False, mixed: bool = False):
    """The 436x1024 H.264 clip with B pictures: the IDR picture of
    ``h264_clip`` (real_im1 in I_PCM), then a P picture every third frame
    whose P_L0_16x16 macroblocks all move by three times ``H264_PAN`` from
    the P before, and the two pictures between as non-reference B pictures
    of B_Skip alone, in temporal direct mode (each interpolates the pan by
    its POC distance: the motion the model sees) or spatial (``spatial``),
    or of random B macroblocks (``mixed``); 13 frames, High profile.
    (SPS, PPS, access units, key flags, each sample's display index)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import h264_syntax as hs
    pad = 448 - FULL_H
    sps = [hs.Sps(profile=100, level=40, mb_w=FULL_W // 16, mb_h=28,
                  crop=(0, 0, 0, pad), max_num_ref_frames=2)]
    pps = [hs.Pps(cabac=cabac, transform_8x8=True)]
    pan = (H264_PAN[0] * H264_B_GOP, H264_PAN[1] * H264_B_GOP)
    b_kw = (dict(mb_types=("B", "SKIP", "I16"), density=0.1, mv_range=8)
            if mixed else dict(mb_types=("SKIP",), skips=1.0))
    pics = [hs.Pic(idr=True, mb_types=("PCM",), pcm=real_im1_planes(),
                   poc=0)]
    for g in range(H264_FRAMES // H264_B_GOP):
        p = H264_B_GOP * (g + 1)
        pics.append(hs.Pic(kind="P", global_mv=pan, poc=2 * p))
        pics += [hs.Pic(kind="B", ref_idc=0, poc=2 * (p - H264_B_GOP + k),
                        direct_spatial=spatial, num_ref_idx1=1, **b_kw)
                 for k in range(1, H264_B_GOP)]
    aus = hs.write_stream(33, sps, pps, pics)
    shown, _ = hs.display_order(pics)
    return sps, pps, aus, [p.idr for p in pics], shown


def phase_h264_b(sd, tmp, corr_fwd, corr_bwd, card: str):
    """H.264 B pictures and rotated tracks through the port's entry points
    on the card machine (host C++ ``runtime/h264.cpp`` behind
    ``io/video.py``): (a) every fixture of the ``h264_b`` group (CAVLC and
    CABAC: B pyramids in spatial and temporal direct mode, every B type,
    the three bi-prediction modes, in the nine containers) and of the
    ``rotation`` group (display matrices cv2 turns frames by) equals cv2's
    digests, fps, size, count and recorded seeks, each picture's planes
    libavcodec's digests, and the B features reached against the
    manifest, and MPEG-2 under transport stream type 0x1B (group
    ``relabel``: cv2's 30 frames, the first 12 concealed by the MPEG-2
    decoder); (b) the video CLI over the 13-frame 436x1024 .mp4 with B
    pictures (``h264_b_clip``, CABAC, ``ctts`` and ``elst``), K1 on the
    card, bf16; (c) the pseudo regime over it, 3 steps (K1 and B1); (d)
    host ms to decode a 436x1024 B picture, all-skipped temporal and
    spatial and of random B macroblocks, CAVLC beside CABAC, beside phase
    32's P picture on the same frames, and swscale's conversion; (e) no
    cv2, PIL or jax imported.  Returns its results, each path's K1 (and
    B1) launches among them."""
    import hashlib
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import h264_syntax as hs
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.runtime import h264

    t_phase = time.perf_counter()
    launches = {}

    # (a) the fixtures
    t0 = time.perf_counter()
    manifest = video_manifest()
    new = fixtures_of(manifest, "h264_b")
    turned = fixtures_of(manifest, "rotation")
    relabelled = fixtures_of(manifest, "relabel")
    coders = {c: sum(f"_{c}" in n for n in new) for c in ("cavlc", "cabac")}
    assert coders["cavlc"] == coders["cabac"] > 0, coders
    assert [w["decoded"] for w in relabelled.values()] == [30], relabelled
    checked = check_fixtures({**new, **turned, **relabelled})
    assert checked["refused"] == [], checked
    planes = 0
    for name, want in sorted(new.items()):
        video = vio.EncodedVideo(os.path.join(MP4_DIR, name))
        got = [hashlib.sha256(b"".join(np.ascontiguousarray(q).tobytes()
                                       for q in p)).hexdigest()
               for _, p in video.planes(0)]
        assert got == want["h264_planes"], name
        planes += len(got)
    reached = {f for w in new.values() for f in w["h264_features"]}
    unreached = [f for f in h264.B_FEATURES if f not in reached]
    assert unreached == manifest["h264_b_unreached"] == [], unreached
    angles = sorted({vio.EncodedVideo(os.path.join(MP4_DIR, n)).rotation
                     for n in turned})
    assert angles == [45, 90, 180, 270], angles
    log(f"[33] (a) {len(new)} B fixtures ({coders['cavlc']} CAVLC, "
        f"{coders['cabac']} CABAC: B pyramids, spatial and temporal direct "
        f"with direct_8x8_inference 1 and 0, every B type and sub type, "
        f"implicit and explicit bi-prediction, list 1's modification and "
        f"swap, long-term and MMCO-marked references, slices; the pyramid "
        f"clip in .mp4/.mov/.mkv/.avi/.ts/.h264/.nut/.wmv/.flv) and "
        f"{len(turned)} rotated tracks (angles {angles}) and MPEG-2 under "
        f"stream_type 0x1B (30 frames, 12 concealed) decoded to "
        f"cv2.VideoCapture's {checked['frames']} frame digests and its "
        f"fps/size/count, {checked['seeks']} seeks ({checked['seeks_none']} "
        f"reading nothing, as cv2's), {planes} pictures' planes to "
        f"libavcodec's, in {time.perf_counter() - t0:.2f} s; B features "
        f"{len(reached & set(h264.B_FEATURES))} of {len(h264.B_FEATURES)}; "
        f"{card}")

    # (b) the video CLI over the 436x1024 .mp4 with B pictures (CABAC)
    t0 = time.perf_counter()
    sps, pps, aus, keys, shown = h264_b_clip(True)
    clip = os.path.join(tmp, "h264_b_pan_436x1024.mp4")
    hs.write_mp4(clip, [hs.length_prefixed(a) for a in aus], keys,
                 hs.avcc(sps, pps), FULL_W, FULL_H, shown=shown)
    write_s = time.perf_counter() - t0
    video = vio.EncodedVideo(clip)
    frames = list(vio.read_frames(clip))
    assert len(frames) == H264_FRAMES and video.h264_delay == 1, \
        (len(frames), video.h264_delay)
    assert frames[0].shape == (FULL_H, FULL_W, 3)
    # the B pictures interpolate the pan: each frame moves by H264_PAN
    # (quarter samples) from the one before, up to the picture's edges
    dx, dy = H264_PAN[0] // 4, H264_PAN[1] // 4
    inner = (slice(32, FULL_H - 32), slice(64, FULL_W - 64))
    for k in range(1, H264_FRAMES):
        a = frames[k][inner].astype(np.int16)
        b = np.roll(frames[k - 1], (-dy, -dx), (0, 1))[inner].astype(np.int16)
        assert np.abs(a - b).mean() < 4.0, (k, np.abs(a - b).mean())
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    k0 = corr_fwd.launches
    row = video_cli([clip, os.path.join(tmp, "out_h264_b.y4m"), "--ckpt",
                     ckpt, "--mode", "arrows", "--batch", str(VIDEO_B),
                     "--dtype", "bfloat16", "--device", "cuda"],
                    H264_FRAMES, FULL_H, FULL_W)
    row["k1_launches"] = launched = corr_fwd.launches - k0
    windows = row.pop("windows")
    assert windows == -(-(H264_FRAMES - 1) // VIDEO_B) == 3, windows
    assert launched == 5 * windows, (launched, windows)
    del row["runner"], row["bytes_uploaded"]
    launches["cli"] = launched
    log(f"[33] (b) extract_video --mode arrows B={VIDEO_B} bf16, H.264 CABAC "
        f".mp4 with B pictures ({H264_FRAMES} frames {FULL_H}x{FULL_W}: "
        f"real_im1 in I_PCM, a P picture every {H264_B_GOP} frames panning "
        f"{H264_PAN} quarter samples a frame, two B_Skip pictures between "
        f"in temporal direct mode; ctts and elst; written in "
        f"{write_s:.2f} s): {row['fps']!r} fps over the run "
        f"({row['run_s']!r} s, fill {row['fill_s']:.2f} s); decode thread "
        f"busy {row['decode_ms']!r} ms a frame ({row['decode_share']:.1%}); "
        f"{windows} windows, K1 {launched} launches; {card}")

    # (c) the pseudo regime over the .mp4
    out_dir = os.path.join(tmp, "h264_b_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", clip, "--pretrained", ckpt,
        "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (H264_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert steps == 3 and [r["step"] for r in recs] == [1, 2, 3], recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[33] (c) cli/train --regime pseudo over the .mp4 with B pictures "
        f"({FULL_H}x{FULL_W} -> 384x512), {steps} steps at batch {TRAIN_B}: "
        f"losses {[r['loss'] for r in recs]}; K1/B1 launches "
        f"{launches['pseudo']} (5 and 5 a step); {wall_t:.2f} s wall; "
        f"{card}")

    # (d) host ms a 436x1024 B picture on one thread, CAVLC beside CABAC:
    # all-skipped temporal and spatial, random B macroblocks; beside the
    # P pictures of the same clips and phase 32's pan P picture
    def timed(units, b_at):
        d = h264.Decoder(delay=1)
        [d.decode(u) for u in units]
        d.flush()
        per = [0.0] * len(units)
        for _ in range(HOST_TIMED):
            d = h264.Decoder(delay=1)
            got = []
            for i, u in enumerate(units):
                t = time.perf_counter()
                got += d.decode(u)
                per[i] += time.perf_counter() - t
            got += d.flush()
        assert len(got) == len(units), (len(got), len(units))
        per = [p / HOST_TIMED * 1e3 for p in per]
        b = [per[i] for i in b_at]
        p = [per[i] for i in range(1, len(units)) if i not in b_at]
        return sum(b) / len(b), sum(p) / len(p), got

    host = {}
    for cabac in (False, True):
        tag = "cabac" if cabac else "cavlc"
        for kind, kw in (("temporal", {}), ("spatial", {"spatial": True}),
                         ("mixed", {"mixed": True})):
            _, _, baus, _, _ = h264_b_clip(cabac, **kw)
            b_at = [i for i in range(1, len(baus)) if i % H264_B_GOP]
            b_ms, p_ms, got = timed(baus, b_at)
            host[f"{kind}_{tag}"] = {
                "b_ms": b_ms, "p_ms": p_ms,
                "bytes_b": sum(len(baus[i]) for i in b_at) / len(b_at)}
        _, _, paus, _ = h264_clip(cabac)
        d = h264.Decoder()
        [d.decode(u) for u in paus]
        t = time.perf_counter()
        for _ in range(HOST_TIMED):
            d = h264.Decoder()
            for u in paus:
                d.decode(u)
            d.flush()
        host[f"clip_p_{tag}"] = (time.perf_counter() - t) / HOST_TIMED \
            / len(paus) * 1e3
    host["convert_ms"] = convert_ms(got)
    t, s_, m = (host["temporal_cabac"], host["spatial_cabac"],
                host["mixed_cabac"])
    log(f"[33] (d) host ms a {FULL_H}x{FULL_W} B picture on one thread, "
        f"CAVLC / CABAC: all B_Skip temporal "
        f"{host['temporal_cavlc']['b_ms']!r} / {t['b_ms']!r}, spatial "
        f"{host['spatial_cavlc']['b_ms']!r} / {s_['b_ms']!r}; random B "
        f"macroblocks {host['mixed_cavlc']['b_ms']!r} / {m['b_ms']!r} "
        f"({host['mixed_cavlc']['bytes_b']:.0f} / {m['bytes_b']:.0f} bytes); "
        f"the clip's P pictures {host['temporal_cavlc']['p_ms']!r} / "
        f"{t['p_ms']!r}; phase 32's clip a frame "
        f"{host['clip_p_cavlc']!r} / {host['clip_p_cabac']!r}; convert "
        f"{host['convert_ms']!r}; {card}")

    # (e) what the port imported
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"
    phase_s = time.perf_counter() - t_phase
    log(f"[33] (e) cv2, PIL, jax not imported; phase 33 took {phase_s:.1f} "
        f"s; {card}")
    return {"fixtures": len(new), "rotated": len(turned), "coders": coders,
            "frames": checked["frames"], "seeks": checked["seeks"],
            "seeks_none": checked["seeks_none"], "planes": planes,
            "unreached": unreached, "cli": row, "host_decode": host,
            "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


# ------------------------------------------------------------ phase 34

CENSUS_FRAMES = 13                     # the CLI's %06d.tif pattern: 3 steps
CENSUS_RPS = 16                        # its files' RowsPerStrip
JLS_CLIP = "jpegls_sintel_436x1024.avi"    # cv2's writer (MJLS), 1 frame
SHQ_CLIP = "speedhq_sintel_436x1024.avi"   # cv2's writer (SHQ0), 2 frames


def real_pair_bgr():
    """``tests/goldens/real_im1.png`` and ``real_im2.png`` nearest-neighbour
    scaled to 436x1024, BGR."""
    import numpy as np
    from opticalflow_tpu_torch.io.images import load_image
    out = []
    for k in (1, 2):
        img = load_image(os.path.join(GOLD, f"real_im{k}.png"))
        rgb = img[np.arange(FULL_H) * img.shape[0] // FULL_H][
            :, np.arange(FULL_W) * img.shape[1] // FULL_W]
        out.append(np.ascontiguousarray(rgb[..., ::-1]))
    return out


def packbits(row: bytes) -> bytes:
    """One row in PackBits: literal runs of up to 128 bytes."""
    out = bytearray()
    for i in range(0, len(row), 128):
        chunk = row[i:i + 128]
        out.append(len(chunk) - 1)
        out += chunk
    return bytes(out)


def tiff_file(width: int, height: int, rows: list, rps: int,
              compression: int = 1, ycbcr: bool = False) -> bytes:
    """A little-endian TIFF of 8-bit RGB rows (``ycbcr``: rows of 2x2 YCbCr
    groups, photometric 6 at subsampling 2x2, as libavcodec's encoder
    writes it), ``rps`` picture rows a strip, uncompressed or PackBits
    (32773), every strip's rows coded one by one."""
    import struct
    per = rps // 2 if ycbcr else rps
    strips = [b"".join(packbits(r) if compression == 32773 else r
                       for r in rows[i:i + per])
              for i in range(0, len(rows), per)]
    n = len(strips)
    tags = [(256, 4, 1, width), (257, 4, 1, height), (258, 3, 3, None),
            (259, 3, 1, compression), (262, 3, 1, 6 if ycbcr else 2),
            (273, 4, n, None), (277, 3, 1, 3), (278, 4, 1, rps),
            (279, 4, n, None)] + ([(530, 3, 2, 2 | 2 << 16)] if ycbcr else [])
    extra = 8 + 2 + 12 * len(tags) + 4
    bps_at, offs_at = extra, extra + 6
    sizes_at = offs_at + 4 * n
    data_at = sizes_at + 4 * n
    offsets, at = [], data_at
    for s in strips:
        offsets.append(at)
        at += len(s)
    out = bytearray(b"II*\0" + struct.pack("<IH", 8, len(tags)))
    for tag, typ, count, value in tags:
        if tag == 258:
            value = bps_at
        elif tag in (273, 279):
            value = (offsets[0] if tag == 273 else len(strips[0])) \
                if n == 1 else (offs_at if tag == 273 else sizes_at)
        packed = (struct.pack("<HH", value, 0) if typ == 3 and count == 1
                  else struct.pack("<I", value))
        out += struct.pack("<HHI", tag, typ, count) + packed
    out += struct.pack("<I", 0) + struct.pack("<3H", 8, 8, 8)
    out += struct.pack(f"<{n}I", *offsets) + struct.pack(
        f"<{n}I", *map(len, strips))
    return bytes(out) + b"".join(strips)


def phase_census(sd, tmp, corr_fwd, corr_bwd, card: str):
    """TIFF, JPEG-LS, SpeedHQ and VP9 in enhanced FLV, the census's last
    pairs, through the port's entry points on the card machine (host C++
    ``runtime/tiff.cpp``, ``runtime/jpegls.cpp``, ``runtime/speedhq.cpp``
    and ``io/flv.py``'s extended tag header behind ``io/video.py``): (a)
    every fixture of the ``tiff`` (cv2's writer in .avi, .mkv, .mov,
    .nut), ``tiff_seq`` (PIL's ``%d.tif`` sequences: every compression,
    Predictor 2, grey 8 and 16, big-endian), ``jpegls``, ``speedhq`` and
    ``flv_vp9`` groups equals cv2's digests, fps, size, count and recorded
    seeks, JPEG-LS's the frames written, SpeedHQ's planes libavcodec's;
    (b) the video CLI over a ``%06d.tif`` pattern of 13 uncompressed
    436x1024 frames written here from the goldens' real pair, K1 on the
    card, bf16; (c) the pseudo regime over the pattern, 3 steps (K1 and
    B1); (d) host ms to decode a 436x1024 frame: TIFF uncompressed RGB
    and PackBits YCbCr 4:2:0 (what cv2's writer makes), JPEG-LS, SpeedHQ,
    each with swscale's conversion; (e) no cv2, PIL or jax imported.
    Returns its results, each path's K1 (and B1) launches among them."""
    import hashlib
    import numpy as np
    import torch
    from opticalflow_tpu_torch.io import video as vio
    from opticalflow_tpu_torch.io.yuv import i420_planes
    from opticalflow_tpu_torch.runtime import jpegls, speedhq, tiff
    from opticalflow_tpu_torch.runtime.mpeg4 import (CHROMA_SITES,
                                                     i420_to_bgr, to_i420)

    t_phase = time.perf_counter()
    launches = {}

    # (a) the fixtures
    t0 = time.perf_counter()
    manifest = video_manifest()
    names = ("tiff", "tiff_seq", "jpegls", "speedhq", "flv_vp9")
    new = fixtures_of(manifest, *names)
    groups = {g: sum(w["group"] == g for w in new.values()) for g in names}
    assert all(groups.values()), groups
    checked = check_fixtures(new)
    assert checked["refused"] == [] and checked["seeks_none"] == 0, checked
    for name, want in new.items():
        if "written_sha256" in want:
            assert want["written_sha256"] == want["sha256"], name
        if "speedhq_planes" in want:
            v = vio.EncodedVideo(os.path.join(MP4_DIR, name))
            dec = v._decoder()
            with open(v.path, "rb") as f:
                got = [hashlib.sha256(b"".join(
                    np.ascontiguousarray(p).tobytes() for p in dec.decode(
                        v.box.sample(f, i)))).hexdigest()
                    for i in range(v.samples)]
            assert got == want["speedhq_planes"], name
    reached = {k: {f for w in new.values() for f in w.get(f"{k}_features",
                                                          [])}
               for k in ("tiff", "jpegls", "speedhq")}
    for k, mod in (("tiff", tiff), ("jpegls", jpegls), ("speedhq", speedhq)):
        assert reached[k] == set(mod.FEATURES), (k, reached[k])
    log(f"[34] (a) {len(new)} fixtures ({groups}: TIFF in .avi/.mkv/.mov/"
        f".nut and as %d.tif sequences in every compression, JPEG-LS "
        f"(colour, grey, LSE), SpeedHQ, VP9 in enhanced FLV) decoded to "
        f"cv2.VideoCapture's {checked['frames']} frame digests and its "
        f"fps/size/count, {checked['seeks']} seeks to the frames cv2's "
        f"read, JPEG-LS to the frames written, SpeedHQ to libavcodec's "
        f"planes, every feature of the three decoders reached, in "
        f"{time.perf_counter() - t0:.2f} s; {card}")

    # (b) the video CLI over a %06d.tif pattern of the real pair
    pair = real_pair_bgr()
    seq_dir = os.path.join(tmp, "tif_frames")
    os.makedirs(seq_dir)
    for i in range(CENSUS_FRAMES):
        rgb = pair[i % 2][..., ::-1]
        with open(os.path.join(seq_dir, f"{i:06d}.tif"), "wb") as f:
            f.write(tiff_file(FULL_W, FULL_H, [r.tobytes() for r in rgb],
                              CENSUS_RPS))
    pattern = os.path.join(seq_dir, "%06d.tif")
    assert vio.video_info(pattern) == {"fps": 25.0, "width": FULL_W,
                                       "height": FULL_H,
                                       "frames": CENSUS_FRAMES}
    for i in (0, 1, CENSUS_FRAMES - 1):
        assert np.array_equal(vio.read_frame(pattern, i), pair[i % 2]), i
    ckpt = os.path.join(tmp, "fake_pwc.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               ckpt)
    k0 = corr_fwd.launches
    row = video_cli([pattern, os.path.join(tmp, "out_tif.y4m"), "--ckpt",
                     ckpt, "--mode", "arrows", "--batch", str(VIDEO_B),
                     "--dtype", "bfloat16", "--device", "cuda"],
                    CENSUS_FRAMES, FULL_H, FULL_W)
    row["k1_launches"] = launched = corr_fwd.launches - k0
    windows = row.pop("windows")
    assert windows == -(-(CENSUS_FRAMES - 1) // VIDEO_B), windows
    assert launched == 5 * windows, (launched, windows)
    del row["runner"], row["bytes_uploaded"]
    launches["cli"] = launched
    log(f"[34] (b) extract_video --mode arrows B={VIDEO_B} bf16 over a "
        f"%06d.tif pattern ({CENSUS_FRAMES} uncompressed frames "
        f"{FULL_H}x{FULL_W}, strips of {CENSUS_RPS} rows): {row['fps']!r} "
        f"fps over the run ({row['run_s']!r} s, fill {row['fill_s']:.2f} "
        f"s); decode thread busy {row['decode_ms']!r} ms a frame "
        f"({row['decode_share']:.1%}); {windows} windows, K1 {launched} "
        f"launches (5 a window); {card}")

    # (c) the pseudo regime over the pattern (436x1024 -> 384x512)
    out_dir = os.path.join(tmp, "tif_pseudo")
    k0, b0 = corr_fwd.launches, corr_bwd.launches
    rc, _, wall_t = train_cli_run([
        "--regime", "pseudo", "--data-root", pattern, "--pretrained", ckpt,
        "--batch", str(TRAIN_B), "--epochs", "1", "--workers", "4",
        "--log-every", "1", "--device", "cuda", "--out-dir", out_dir])
    assert rc == 0, rc
    steps = (CENSUS_FRAMES - 1) // TRAIN_B
    recs = [r for r in jsonl(os.path.join(out_dir, "metrics.jsonl"))
            if "step" in r]
    launches["pseudo"] = {"correlation_fwd": corr_fwd.launches - k0,
                          "correlation_bwd": corr_bwd.launches - b0}
    assert steps == 3 and [r["step"] for r in recs] == [1, 2, 3], recs
    assert all(np.isfinite(r["loss"]) for r in recs), recs
    assert launches["pseudo"] == {"correlation_fwd": 5 * steps,
                                  "correlation_bwd": 5 * steps}, launches
    log(f"[34] (c) cli/train --regime pseudo over the %06d.tif pattern "
        f"({FULL_H}x{FULL_W} -> 384x512), {steps} steps at batch {TRAIN_B}: "
        f"losses {[r['loss'] for r in recs]}; K1/B1 launches "
        f"{launches['pseudo']} (5 and 5 a step); {wall_t:.2f} s wall; "
        f"{card}")

    # (d) host ms a 436x1024 frame on one thread, decode and conversion
    host = {}
    raw = [open(os.path.join(seq_dir, f"{i:06d}.tif"), "rb").read()
           for i in range(2)]
    ms, got = host_decode(lambda: tiff.Decoder("raw"), raw)
    assert [np.array_equal(g, p) for g, p in zip(got, pair)] == [True] * 2
    host["tiff_raw_rgb"] = {"decode_ms": ms, "convert_ms": 0.0,
                            "bytes_a_frame": sum(map(len, raw)) / 2}
    ycc = []
    for bgr in pair:
        y, u, v = i420_planes(to_i420(bgr))
        g = np.concatenate([
            y.reshape(FULL_H // 2, 2, FULL_W // 2, 2).transpose(
                0, 2, 1, 3).reshape(FULL_H // 2, FULL_W // 2, 4),
            u[..., None], v[..., None]], axis=2)
        ycc.append((tiff_file(FULL_W, FULL_H, [r.tobytes() for r in g], 56,
                              32773, ycbcr=True), (y, u, v)))
    ms, got = host_decode(lambda: tiff.Decoder("ycc"), [t for t, _ in ycc])
    for p, (_, want) in zip(got, ycc):
        assert all(np.array_equal(a, b) for a, b in zip(p, want))
    host["tiff_packbits_ycbcr420"] = {
        "decode_ms": ms, "convert_ms": convert_ms(got),
        "bytes_a_frame": sum(len(t) for t, _ in ycc) / 2}
    for key, clip, make in (
            ("jpegls", JLS_CLIP, lambda: jpegls.Decoder("jls")),
            ("speedhq", SHQ_CLIP,
             lambda: speedhq.Decoder(FULL_W, FULL_H, what="shq"))):
        v = vio.EncodedVideo(os.path.join(MP4_DIR, clip))
        with open(v.path, "rb") as f:
            samples = [v.box.sample(f, i) for i in range(v.samples)]
        ms, got = host_decode(make, samples)
        want = manifest["files"][clip]["sha256"]
        if key == "jpegls":
            assert [pixel_digest(g) for g in got] == want
            conv = 0.0
        else:
            conv = convert_ms(got)
            assert [pixel_digest(i420_to_bgr(
                *g, chroma=CHROMA_SITES["center"])) for g in got] == want
        host[key] = {"decode_ms": ms, "convert_ms": conv,
                     "bytes_a_frame": sum(map(len, samples)) / len(samples)}
    log(f"[34] (d) host ms a {FULL_H}x{FULL_W} frame on one thread (decode "
        f"+ swscale's conversion): " + "; ".join(
            f"{k} {h['decode_ms']!r} + {h['convert_ms']!r} "
            f"({h['bytes_a_frame']:.0f} bytes a frame)"
            for k, h in host.items()) + f"; {card}")

    # (e) what the port imported
    present = [m for m in ("cv2", "PIL", "jax") if m in sys.modules]
    assert not present, f"imported: {present}"
    phase_s = time.perf_counter() - t_phase
    log(f"[34] (e) cv2, PIL, jax not imported; phase 34 took {phase_s:.1f} "
        f"s; {card}")
    return {"fixtures": len(new), "groups": groups,
            "frames": checked["frames"], "seeks": checked["seeks"],
            "cli": row, "host_decode": host,
            "pseudo_losses": [r["loss"] for r in recs],
            "launches": launches, "phase_s": phase_s, "card": card}


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "opticalflow_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(opticalflow_tpu_torch/ not found beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from opticalflow_tpu_torch.ops.corr_cuda import (correlation_bwd_cuda,
                                                     correlation_cuda)
    from opticalflow_tpu_torch.ops.fused_warpcorr import fused_warp_corr_cuda
    from opticalflow_tpu_torch.ops.gather import row_gather_cuda
    from opticalflow_tpu_torch.scripts import (probe_fused_warpcorr,
                                               probe_gather)
    counters = (correlation_cuda, correlation_bwd_cuda, fused_warp_corr_cuda,
                row_gather_cuda)

    def zero_counts():
        for k in counters:
            k.launches = 0

    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    phase_build()
    k1_err, k1_rows, k2_rows, k1_rows_bf16 = phase_corr_vs_plain()
    k3_err, k3_err_bf16, k3_excluded = phase_fused_vs_plain()

    zero_counts()                           # K3's path starts here
    log("[3] probe_fused_warpcorr.main():")
    k3_rows = probe_fused_warpcorr.main([])
    k3_launches = fused_warp_corr_cuda.launches   # ... and ends here
    assert k3_launches > 0 and k3_rows
    for dtype in ("float32", "bfloat16"):
        for b in (1, 8):
            sel = [r for r in k3_rows
                   if r["batch"] == b and r["dtype"] == dtype]
            fused, comp = (sum(r[k] for r in sel) * 1e3 for k in
                           ("fused_device_ms", "composed_device_ms"))
            log(f"[3] levels 2-5 of 448x1024, B={b} {dtype}: card alone "
                f"fused {fused:.2f} us, composed {comp:.2f} us "
                f"({comp / fused:.2f}x), bound "
                f"{sum(r['bound_ms'] for r in sel) * 1e3:.2f} us")

    k4_err, k4_plain_ms, launch_floor_ms = phase_gather_vs_plain()
    zero_counts()                           # K4's path starts here
    log("[4] probe_gather.main():")
    k4_rows = probe_gather.main([])
    k4_launches = row_gather_cuda.launches  # ... and ends here
    assert k4_launches > 0 and k4_rows["kernel"]["correct"]

    zero_counts()                           # the main path starts here
    with tempfile.TemporaryDirectory() as tmp:
        sd = phase_cli(tmp, correlation_cuda)
    engine, _ = phase_full_width(sd, correlation_cuda)
    k1_launches = correlation_cuda.launches  # ... and ends here
    assert k1_launches > 0
    phase_forward_time(engine)

    b1_err, b1_err_bf16, b1_rows = phase_corr_bwd()
    train = phase_train(sd, correlation_cuda, correlation_bwd_cuda)
    b1_launches = train["launches"]["correlation_bwd"]
    zero_counts()                           # the eval path starts here
    with tempfile.TemporaryDirectory() as tmp:
        evals = phase_eval(sd, tmp, correlation_cuda)
    eval_launches = correlation_cuda.launches  # ... and ends here
    assert eval_launches > 0
    with tempfile.TemporaryDirectory() as tmp:
        train_cli = phase_train_cli(sd, tmp, correlation_cuda,
                                    correlation_bwd_cuda, card_line())

    t_video = time.perf_counter()
    video_checks = phase_video_checks(sd)
    zero_counts()                           # the video path starts here
    with tempfile.TemporaryDirectory() as tmp:
        video = phase_video(sd, tmp, correlation_cuda, card_line())
        video_launches = correlation_cuda.launches   # ... and ends here
        assert video_launches > 0
        video["forward_ms"] = phase_video_forward(sd, card_line())
        video["engine"] = phase_video_engine(sd, tmp)
    video["checks"] = video_checks
    video["card"] = card_line()
    video["phase_s"] = time.perf_counter() - t_video
    log(f"[11] phase 11 took {video['phase_s']:.1f} s")

    zero_counts()                           # the serving path starts here
    with tempfile.TemporaryDirectory() as tmp:
        serve = phase_serve(sd, tmp, correlation_cuda, card_line())
    # ... and ends here: the CLI's launches (counted in its process from 0)
    # and the parity-mode server's (this process, its burst alone)
    serve_launches = serve["launches_cli"] + serve["launches_parity"]
    assert serve_launches > 0
    zero_counts()                           # the export path starts here
    with tempfile.TemporaryDirectory() as tmp:
        export = phase_export(sd, tmp, correlation_cuda, card_line())
    export_launches = export["launches"]    # ... and ends here
    assert export_launches > 0 and correlation_cuda.launches >= \
        export_launches
    zero_counts()                # the data-parallel paths start here: each
    with tempfile.TemporaryDirectory() as tmp:   # rank counts its own
        dp = phase_data_parallel(sd, tmp, (correlation_cuda,
                                           correlation_bwd_cuda),
                                 card_line(), train["step_ms_median"])
    # ... and end here: every rank launched K1 (and B1 on the train paths)
    assert all(r["parity"]["correlation_bwd"] > 0
               and r["fast"]["correlation_fwd"] > 0
               for r in dp["launches"]["ranks"])
    zero_counts()                           # the JPEG paths start here
    with tempfile.TemporaryDirectory() as tmp:
        jpg = phase_jpeg(sd, tmp, correlation_cuda, correlation_bwd_cuda,
                         card_line())
    # ... and end here: the CLI's, the serving child's (counted in its
    # process), the pseudo steps' and the video CLI's launches
    jpeg_launches = (jpg["launches"]["cli"] + jpg["launches"]["serve"]
                     + jpg["launches"]["pseudo"]["correlation_fwd"]
                     + jpg["launches"]["video"])
    assert jpeg_launches > 0 and \
        jpg["launches"]["pseudo"]["correlation_bwd"] > 0
    zero_counts()                           # the compare path starts here
    with tempfile.TemporaryDirectory() as tmp:
        compare = phase_compare(sd, tmp, correlation_cuda, card_line())
    compare_launches = correlation_cuda.launches  # ... and ends here
    assert compare_launches > 0
    zero_counts()                           # the MPEG-4 paths start here
    with tempfile.TemporaryDirectory() as tmp:
        mp4 = phase_mp4(sd, tmp, correlation_cuda, correlation_bwd_cuda,
                        card_line())
    # ... and end here: the video CLI's runs and the pseudo steps
    mp4_launches = mp4["launches"]["cli"] + \
        mp4["launches"]["pseudo"]["correlation_fwd"]
    assert mp4_launches == correlation_cuda.launches > 0
    assert mp4["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0
    zero_counts()                # the Motion JPEG / sequence paths start here
    with tempfile.TemporaryDirectory() as tmp:
        seq = phase_mjpeg(sd, tmp, correlation_cuda, correlation_bwd_cuda,
                          card_line())
    # ... and end here: the video CLI's runs and the pseudo steps
    seq_launches = seq["launches"]["cli"] + \
        seq["launches"]["pseudo"]["correlation_fwd"]
    assert seq_launches == correlation_cuda.launches > 0
    assert seq["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0
    zero_counts()                # the VP8 / Matroska paths start here
    with tempfile.TemporaryDirectory() as tmp:
        vp8 = phase_vp8(sd, tmp, correlation_cuda, correlation_bwd_cuda,
                        card_line())
    # ... and end here: the video CLI's runs and the pseudo steps
    vp8_launches = vp8["launches"]["cli"] + \
        vp8["launches"]["pseudo"]["correlation_fwd"]
    assert vp8_launches == correlation_cuda.launches > 0
    assert vp8["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0
    zero_counts()                # the VP9 paths start here
    with tempfile.TemporaryDirectory() as tmp:
        vp9 = phase_vp9(sd, tmp, correlation_cuda, correlation_bwd_cuda,
                        card_line())
    # ... and end here: the video CLI's runs and the pseudo steps
    vp9_launches = vp9["launches"]["cli"] + \
        vp9["launches"]["pseudo"]["correlation_fwd"]
    assert vp9_launches == correlation_cuda.launches > 0
    assert vp9["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0
    zero_counts()                # the MPEG-1/2 paths start here
    with tempfile.TemporaryDirectory() as tmp:
        m12 = phase_mpeg12(sd, tmp, correlation_cuda, correlation_bwd_cuda,
                           card_line())
    # ... and end here: the video CLI's runs and the pseudo steps
    m12_launches = m12["launches"]["cli"] + \
        m12["launches"]["pseudo"]["correlation_fwd"]
    assert m12_launches == correlation_cuda.launches > 0
    assert m12["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0
    zero_counts()                # the H.263 / size-change paths start here
    with tempfile.TemporaryDirectory() as tmp:
        h263 = phase_h263(sd, tmp, correlation_cuda, correlation_bwd_cuda,
                          card_line())
    # ... and end here: the video CLI's runs and the pseudo steps
    h263_launches = h263["launches"]["cli"] + \
        h263["launches"]["pseudo"]["correlation_fwd"]
    assert h263_launches == correlation_cuda.launches > 0
    assert h263["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0
    zero_counts()                # the transport stream / FFV1 paths start here
    with tempfile.TemporaryDirectory() as tmp:
        streams = phase_streams(sd, tmp, correlation_cuda,
                                correlation_bwd_cuda, card_line())
    # ... and end here: the video CLI's runs and the pseudo steps
    streams_launches = streams["launches"]["cli"] + \
        streams["launches"]["pseudo"]["correlation_fwd"]
    assert streams_launches == correlation_cuda.launches > 0
    assert streams["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0
    zero_counts()         # the H.263+ / 16-bit PNG / PTS-only paths start here
    with tempfile.TemporaryDirectory() as tmp:
        plus = phase_plus(sd, tmp, correlation_cuda, correlation_bwd_cuda,
                          card_line())
    # ... and end here: the video CLI's run and the pseudo steps
    plus_launches = plus["launches"]["cli"] + \
        plus["launches"]["pseudo"]["correlation_fwd"]
    assert plus_launches == correlation_cuda.launches > 0
    assert plus["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0
    zero_counts()                # the lossless video paths start here
    with tempfile.TemporaryDirectory() as tmp:
        lossless = phase_lossless(sd, tmp, correlation_cuda,
                                  correlation_bwd_cuda, card_line())
    # ... and end here: the video CLI's run and the pseudo steps
    lossless_launches = lossless["launches"]["cli"] + \
        lossless["launches"]["pseudo"]["correlation_fwd"]
    assert lossless_launches == correlation_cuda.launches > 0
    assert lossless["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0
    zero_counts()     # the MagicYUV / Sorenson / ASV paths start here
    with tempfile.TemporaryDirectory() as tmp:
        mfa = phase_magy_flv_asv(sd, tmp, correlation_cuda,
                                 correlation_bwd_cuda, card_line())
    # ... and end here: the video CLI's run and the pseudo steps
    magy_flv_asv_launches = mfa["launches"]["cli"] + \
        mfa["launches"]["pseudo"]["correlation_fwd"]
    assert magy_flv_asv_launches == correlation_cuda.launches > 0
    assert mfa["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0
    zero_counts()            # the MS-MPEG4 / WMV / ASF paths start here
    with tempfile.TemporaryDirectory() as tmp:
        msm = phase_msmpeg4(sd, tmp, correlation_cuda, correlation_bwd_cuda,
                            card_line())
    # ... and end here: the video CLI's run and the pseudo steps
    msmpeg4_launches = msm["launches"]["cli"] + \
        msm["launches"]["pseudo"]["correlation_fwd"]
    assert msmpeg4_launches == correlation_cuda.launches > 0
    assert msm["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0
    zero_counts()                # the Snow paths start here
    with tempfile.TemporaryDirectory() as tmp:
        snw = phase_snow(sd, tmp, correlation_cuda, correlation_bwd_cuda,
                         card_line())
    # ... and end here: the video CLI's run and the pseudo steps
    snow_launches = snw["launches"]["cli"] + \
        snw["launches"]["pseudo"]["correlation_fwd"]
    assert snow_launches == correlation_cuda.launches > 0
    assert snw["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0
    zero_counts()                # the NUT / Dirac paths start here
    with tempfile.TemporaryDirectory() as tmp:
        nd = phase_nut_dirac(sd, tmp, correlation_cuda, correlation_bwd_cuda,
                             card_line())
    # ... and end here: the video CLI's run and the pseudo steps
    nut_dirac_launches = nd["launches"]["cli"] + \
        nd["launches"]["pseudo"]["correlation_fwd"]
    assert nut_dirac_launches == correlation_cuda.launches > 0
    assert nd["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0
    zero_counts()                # the writer's container paths start here
    with tempfile.TemporaryDirectory() as tmp:
        cont = phase_containers(sd, tmp, correlation_cuda, card_line(),
                                mp4["cli"])
    # ... and end here: the video CLI's two runs
    containers_launches = sum(cont["launches"].values())
    assert containers_launches == correlation_cuda.launches == 30, \
        containers_launches
    assert correlation_bwd_cuda.launches == 0
    zero_counts()                # the JPEG 2000 paths start here
    with tempfile.TemporaryDirectory() as tmp:
        j2k = phase_jpeg2000(sd, tmp, correlation_cuda, correlation_bwd_cuda,
                             card_line())
    # ... and end here: the video CLI's run and the pseudo steps
    jpeg2000_launches = j2k["launches"]["cli"] + \
        j2k["launches"]["pseudo"]["correlation_fwd"]
    assert jpeg2000_launches == correlation_cuda.launches > 0
    assert j2k["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0
    zero_counts()                # the H.264 paths start here
    with tempfile.TemporaryDirectory() as tmp:
        avc = phase_h264(sd, tmp, correlation_cuda, correlation_bwd_cuda,
                         card_line())
    # ... and end here: the video CLI's run and the pseudo steps
    h264_launches = avc["launches"]["cli"] + \
        avc["launches"]["pseudo"]["correlation_fwd"]
    assert h264_launches == correlation_cuda.launches > 0
    assert avc["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0
    zero_counts()                # the H.264 B picture paths start here
    with tempfile.TemporaryDirectory() as tmp:
        avc_b = phase_h264_b(sd, tmp, correlation_cuda, correlation_bwd_cuda,
                             card_line())
    # ... and end here: the video CLI's run and the pseudo steps
    h264_b_launches = avc_b["launches"]["cli"] + \
        avc_b["launches"]["pseudo"]["correlation_fwd"]
    assert h264_b_launches == correlation_cuda.launches > 0
    assert avc_b["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0
    zero_counts()                # the census's last codecs start here
    with tempfile.TemporaryDirectory() as tmp:
        census = phase_census(sd, tmp, correlation_cuda,
                              correlation_bwd_cuda, card_line())
    # ... and end here: the video CLI's run and the pseudo steps
    census_launches = census["launches"]["cli"] + \
        census["launches"]["pseudo"]["correlation_fwd"]
    assert census_launches == correlation_cuda.launches > 0
    assert census["launches"]["pseudo"]["correlation_bwd"] == \
        correlation_bwd_cuda.launches > 0

    # one forward's worth: the levels of a 448x1024 pair, B=1, float32
    k1 = summed([r for r in k1_rows if r["batch"] == 1])
    k2 = summed(k2_rows)
    k3_f32_b1 = [r for r in k3_rows
                 if r["batch"] == 1 and r["dtype"] == "float32"]
    k3 = summed(k3_f32_b1, "fused_ms")
    b1 = summed([r for r in b1_rows if r["frame"] == "320x896"
                 and r["dtype"] == "float32"])
    kernels = [
        {"name": "correlation_fwd", "route": "cuda",
         "source": "opticalflow_tpu_torch/csrc/correlation_fwd.cu",
         "replaces": "opticalflow_tpu/ops/pallas_corr.py:113",
         "also_replaces": "opticalflow_tpu/ops/pallas_corr.py:138",
         "launches": k1_launches, "max_abs_err": k1_err, **k1,
         "library_ms": None, "per_level": k1_rows,
         "per_level_bf16": k1_rows_bf16,
         # K2's domain: one forward's worth at 1088x1920, B=1, float32
         "at_1088x1920": {**k2, "per_level": k2_rows},
         # its launches on the training path (5 per step) and the eval path
         "launches_train": train["launches"]["correlation_fwd"],
         "launches_eval": eval_launches, "eval": evals,
         # the training CLI's runs (phase 10: steps, validation, masks)
         "launches_train_cli": train_cli["launches"]["correlation_fwd"],
         # the video CLIs' runs (phase 11: 5 a window, 720p and 1080p)
         "launches_video": video_launches, "video": video,
         # the serving CLI and a parity-mode server (phase 12: 5 a batch)
         "launches_serve": serve_launches, "serve": serve,
         # loaded artifacts and the parity CLI (phase 13: 5 a call)
         "launches_export": export_launches, "export": export,
         # phase 14, per rank: 2 gloo ranks on the card (the parity step,
         # fast steps, a lockstep server, halo and tiled spatial paths: 5 a
         # forward), a one-rank NCCL group's steps, the 2-rank eval CLI
         "launches_data_parallel": dp["launches"], "data_parallel": dp,
         # phase 15: the JPEG paths (CLI, serving CLI, pseudo steps, video
         # CLI over a JPEG directory at 1080x1920: 5 a forward)
         "launches_jpeg": jpeg_launches, "jpeg": jpg,
         # phase 16: compare mode, the three baselines (5 a window)
         "launches_compare": compare_launches, "compare": compare,
         # phase 17: the video CLI over .mp4 (720p, 1080p) and .y4m, and
         # the pseudo steps over an .mp4 (5 a window, 5 a step)
         "launches_mp4": mp4_launches, "mp4": mp4,
         # phase 18: the video CLI over a %06d.jpg pattern, an MJPEG AVI
         # (436x1024, 1080p) and a .y4m, and the pseudo steps over a
         # pattern (5 a window, 5 a step)
         "launches_mjpeg": seq_launches, "mjpeg": seq,
         # phase 19: the video CLI over the 436x1024 VP8 WebM (to .y4m and
         # to .mkv) and a .y4m of its frames, and the pseudo steps over a
         # .webm (5 a window, 5 a step)
         "launches_vp8": vp8_launches, "vp8": vp8,
         # phase 20: the video CLI over the 436x1024 VP9 WebM (to .y4m and
         # to .mkv) and a .y4m of its frames, and the pseudo steps over a
         # VP9 .webm (5 a window, 5 a step)
         "launches_vp9": vp9_launches, "vp9": vp9,
         # phase 21: the video CLI over the 436x1024 MPEG-2 .mpg (to .y4m
         # and to .mkv) and a .y4m of its frames, and the pseudo steps over
         # an MPEG-2 .mpg (5 a window, 5 a step)
         "launches_mpeg12": m12_launches, "mpeg12": m12,
         # phase 22: the video CLI over the 4CIF H.263 AVI and the resizing
         # 436x1024 VP9 WebM, and the pseudo steps over the WebM's head (5
         # a window, 5 a step)
         "launches_h263": h263_launches, "h263": h263,
         # phase 23: the video CLI over the 436x1024 MPEG-2 .ts and FFV1
         # .mkv, and the pseudo steps over a low-delay MPEG-2 .ts (5 a
         # window, 5 a step)
         "launches_streams": streams_launches, "streams": streams,
         # phase 24: the video CLI over the 436x1024 H.263+ AVI, and the
         # pseudo steps over its first 9 frames (5 a window, 5 a step)
         "launches_plus": plus_launches, "plus": plus,
         # phase 25: the video CLI over the 436x1024 HuffYUV AVI, and the
         # pseudo steps over 9 frames of its packets (5 a window, 5 a step)
         "launches_lossless": lossless_launches, "lossless": lossless,
         # phase 26: the video CLI over the 436x1024 Sorenson .flv, and the
         # pseudo steps over the same .flv (5 a window, 5 a step)
         "launches_magy_flv_asv": magy_flv_asv_launches,
         "magy_flv_asv": mfa,
         # phase 27: the video CLI over the 436x1024 WMV8 .wmv, and the
         # pseudo steps over the same .wmv (5 a window, 5 a step)
         "launches_msmpeg4": msmpeg4_launches, "msmpeg4": msm,
         # phase 28: the video CLI over the 436x1024 Snow AVI, and the
         # pseudo steps over the same AVI (5 a window, 5 a step)
         "launches_snow": snow_launches, "snow": snw,
         # phase 29: the video CLI over the 436x1024 VC-2 .nut, and the
         # pseudo steps over its packets in AVI (5 a window, 5 a step)
         "launches_nut_dirac": nut_dirac_launches, "nut_dirac": nd,
         # phase 30: the video CLI over the 436x1024 clip into .mov and .ts
         # (5 a window, 15 a run)
         "launches_containers": containers_launches, "containers": cont,
         # phase 31: the video CLI over the 436x1024 JPEG 2000 AVI, and the
         # pseudo steps over its packets cycled in AVI (5 a window, 5 a
         # step)
         "launches_jpeg2000": jpeg2000_launches, "jpeg2000": j2k,
         # phase 32: the video CLI over the 436x1024 H.264 .mp4, and the
         # pseudo steps over it (5 a window, 5 a step)
         "launches_h264": h264_launches, "h264": avc,
         # phase 33: the video CLI over the 436x1024 H.264 .mp4 with B
         # pictures, and the pseudo steps over it (5 a window, 5 a step)
         "launches_h264_b": h264_b_launches, "h264_b": avc_b,
         # phase 34: the video CLI over a 436x1024 %06d.tif pattern, and
         # the pseudo steps over it (5 a window, 5 a step)
         "launches_census": census_launches, "census": census},
        {"name": "correlation_bwd", "route": "cuda",
         "source": "opticalflow_tpu_torch/csrc/correlation_bwd.cu",
         # no TPU kernel: the JAX custom_vjp's backward is lax
         "replaces": "opticalflow_tpu/ops/pallas_corr.py:253",
         "launches": b1_launches, "max_abs_err": b1_err,
         "max_abs_err_bf16": b1_err_bf16,
         # one training step's worth: the 5 levels of 320x896, B=4, float32
         **b1, "library_ms": None,
         # per level of that step: the plan the kernel chose
         "plan": [{k: r[k] for k in ("level", "tile", "split",
                                     "channels_per_split", "threads",
                                     "blocks_per_sm", "registers")}
                  for r in b1_rows if r["frame"] == "320x896"
                  and r["dtype"] == "float32"],
         "per_level": b1_rows, "train_step": train,
         "launches_train_cli": train_cli["launches"]["correlation_bwd"],
         "train_cli": train_cli,
         # phase 14, per rank: 5 a step on every rank
         "launches_data_parallel": {
             "ranks": [{k: v["correlation_bwd"] for k, v in r.items()}
                       for r in dp["launches"]["ranks"]],
             "one_rank_nccl":
                 dp["launches"]["one_rank_nccl"]["correlation_bwd"]},
         # phase 15: the pseudo regime's steps over JPEG frames, 5 a step
         "launches_jpeg_pseudo":
             jpg["launches"]["pseudo"]["correlation_bwd"],
         # phase 17: the pseudo regime's steps over an .mp4, 5 a step
         "launches_mp4": mp4["launches"]["pseudo"]["correlation_bwd"],
         # phase 18: the pseudo regime's steps over a %06d.jpg pattern
         "launches_mjpeg": seq["launches"]["pseudo"]["correlation_bwd"],
         # phase 19: the pseudo regime's steps over a .webm
         "launches_vp8": vp8["launches"]["pseudo"]["correlation_bwd"],
         # phase 20: the pseudo regime's steps over a VP9 .webm
         "launches_vp9": vp9["launches"]["pseudo"]["correlation_bwd"],
         # phase 21: the pseudo regime's steps over an MPEG-2 .mpg
         "launches_mpeg12": m12["launches"]["pseudo"]["correlation_bwd"],
         # phase 22: the pseudo regime's steps over the resizing VP9 WebM
         "launches_h263": h263["launches"]["pseudo"]["correlation_bwd"],
         # phase 23: the pseudo regime's steps over an MPEG-2 .ts
         "launches_streams":
             streams["launches"]["pseudo"]["correlation_bwd"],
         # phase 24: the pseudo regime's steps over an H.263+ AVI
         "launches_plus": plus["launches"]["pseudo"]["correlation_bwd"],
         # phase 25: the pseudo regime's steps over a HuffYUV AVI
         "launches_lossless":
             lossless["launches"]["pseudo"]["correlation_bwd"],
         # phase 26: the pseudo regime's steps over a Sorenson .flv
         "launches_magy_flv_asv":
             mfa["launches"]["pseudo"]["correlation_bwd"],
         # phase 27: the pseudo regime's steps over a WMV8 .wmv
         "launches_msmpeg4": msm["launches"]["pseudo"]["correlation_bwd"],
         # phase 28: the pseudo regime's steps over a Snow .avi
         "launches_snow": snw["launches"]["pseudo"]["correlation_bwd"],
         # phase 29: the pseudo regime's steps over VC-2 packets in AVI
         "launches_nut_dirac":
             nd["launches"]["pseudo"]["correlation_bwd"],
         # phase 31: the pseudo regime's steps over JPEG 2000 packets
         "launches_jpeg2000": j2k["launches"]["pseudo"]["correlation_bwd"],
         # phase 32: the pseudo regime's steps over the H.264 .mp4
         "launches_h264": avc["launches"]["pseudo"]["correlation_bwd"],
         # phase 33: the pseudo regime's steps over the B picture .mp4
         "launches_h264_b":
             avc_b["launches"]["pseudo"]["correlation_bwd"],
         # phase 34: the pseudo regime's steps over the %06d.tif pattern
         "launches_census":
             census["launches"]["pseudo"]["correlation_bwd"]},
        {"name": "fused_warp_corr", "route": "cuda",
         "source": "opticalflow_tpu_torch/csrc/fused_warp_corr.cu",
         "replaces": "scripts/probe_fused_warpcorr.py:80",
         "launches": k3_launches, "max_abs_err": k3_err,
         "max_abs_err_bf16": k3_err_bf16, "excluded_pixels": k3_excluded,
         **k3, "library_ms": None,
         # no single PyTorch call computes it; the composed path (warp,
         # then K1) is the yardstick
         "composed_ms": sum(r["composed_ms"] for r in k3_f32_b1),
         # the same with the host out of the way (calls queued behind a
         # spin kernel)
         "device_ms": sum(r["fused_device_ms"] for r in k3_f32_b1),
         "composed_device_ms": sum(r["composed_device_ms"]
                                   for r in k3_f32_b1),
         # per level 2-5 (B=1, float32): the plan chosen and the card's time
         "plan": [r["plan"] for r in k3_f32_b1],
         "per_level_device_ms": [r["fused_device_ms"] for r in k3_f32_b1],
         "per_shape": k3_rows},
        {"name": "row_gather", "route": "cuda",
         "source": "opticalflow_tpu_torch/csrc/row_gather.cu",
         "replaces": "scripts/probe_gather.py:26",
         "launches": k4_launches, "max_abs_err": k4_err,
         "ms": k4_rows["kernel"]["ms"], "plain_ms": k4_plain_ms,
         "bound_ms": k4_rows["kernel"]["bound_ms"],
         "bound_by": k4_rows["kernel"]["bound_by"],
         "library_ms": k4_rows["index_select"]["ms"],
         "host_ms": k4_rows["kernel"]["host_ms"],
         "library_host_ms": k4_rows["index_select"]["host_ms"],
         "device_ms": k4_rows["kernel"]["device_ms"],
         "library_device_ms": k4_rows["index_select"]["device_ms"],
         "wrapper_pieces": k4_rows["wrapper_pieces"],
         # the smallest launch through the shared launch path (one row)
         "launch_floor_ms": launch_floor_ms,
         "at_1M_rows": {"ms": k4_rows["kernel_large"]["ms"],
                        "library_ms": k4_rows["index_select_large"]["ms"],
                        "bound_ms": k4_rows["kernel_large"]["bound_ms"]}},
    ]
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
