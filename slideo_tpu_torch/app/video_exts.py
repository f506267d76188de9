"""Video file-extension classification.

The port's copy of ``slideo_tpu/app/video_exts.py``. The accepted set is
the reference's (crates/app/src/video_exts.rs:4-6): the ffmpeg demuxer
names of ``ffmpeg -demuxers`` (audio-only ones included, as the reference
accepts them; OpenCV yields zero video frames for those), plus a few common
file extensions those demuxers read.
"""

VIDEO_EXTS = frozenset(
    """
    3dostr 3g2 3gp 4xm a64 aa aac ac3 acm act adf adp ads adts adx aea afc
    aiff aix alaw alias_pix alp amr amrnb amrwb anm apc ape apm apng aptx
    aptx_hd aqtitle argo_asf asf asf_o asf_stream ass ast au av1 avi
    avisynth avm2 avr avs avs2 bethsoftvid bfi bfstm bin bink bit bmp_pipe
    bmv boa brender_pix brstm c93 caf cavsvideo cdg cdxl cine codec2
    codec2raw concat crc dash data daud dcstr dds_pipe derf dfa dhav dirac
    dnxhd dpx_pipe dsf dshow dsicin dss dts dtshd dv dvbsub dvbtxt dvd dxa
    ea ea_cdata eac3 epaf exr_pipe f32be f32le f4v f64be f64le ffmetadata
    fifo fifo_test film_cpk filmstrip fits flac flic flv framecrc framehash
    framemd5 frm fsb fwse g722 g723_1 g726 g726le g729 gdigrab gdv genh gif
    gif_pipe gsm gxf h261 h263 h264 hash hca hcom hds hevc hls hnm ico
    idcin idf iff ifv ilbc image2 image2pipe ingenient ipmovie ipod ircam
    ismv iss iv8 ivf ivr j2k_pipe jacosub jpeg_pipe jpegls_pipe jv kux kvag
    latm lavfi libgme libopenmpt live_flv lmlm4 loas lrc lvf lxf m4v
    matroska md5 mgsts microdvd mjpeg mjpeg_2000 mkvtimestamp_v2 mlp mlv mm
    mmf mov mp2 mp3 mp4 mpc mpc8 mpeg mpeg1video mpeg2video mpegts
    mpegtsraw mpegvideo mpjpeg mpl2 mpsub msf msnwctcp mtaf mtv mulaw musx
    mv mvi mxf mxf_d10 mxf_opatom mxg nc nistsphere nsp nsv null nut nuv
    oga ogg ogv oma opus paf pam_pipe pbm_pipe pcx_pipe pgm_pipe
    pgmyuv_pipe pictor_pipe pjs pmp png_pipe pp_bnk ppm_pipe psd_pipe psp
    psxstr pva pvf qcp qdraw_pipe r3d rawvideo realtext redspark rl2 rm roq
    rpl rsd rso rtp rtp_mpegts rtsp s16be s16le s24be s24le s32be s32le
    s337m s8 sami sap sbc sbg scc sdl sdp sdr2 sds sdx segment ser sgi_pipe
    shn siff singlejpeg sln smjpeg smk smoothstreaming smush sol sox spdif
    spx srt stl stream_segment streamhash subviewer subviewer1 sunrast_pipe
    sup svag svcd svg_pipe swf tak tedcaptions tee thp tiertexseq tiff_pipe
    tmv truehd tta tty txd ty u16be u16le u24be u24le u32be u32le u8
    uncodedframecrc v210 v210x vag vc1 vc1test vcd vfwcap vidc vividas vivo
    vmd vob vobsub voc vpk vplayer vqf w64 wav wc3movie webm webm_chunk
    webm_dash_manifest webp webp_pipe webvtt wsaud wsd wsvqa wtv wv wve xa
    xbin xmv xpm_pipe xvag xwd_pipe xwma yop yuv4mpegpipe
    """.split()
) | frozenset(
    # The reference list holds ffmpeg *demuxer names*, which miss a few
    # common real file extensions those demuxers serve (e.g. the matroska
    # demuxer reads .mkv, but "mkv" is absent from `ffmpeg -demuxers`).
    # Accepting them is a strict superset of the reference's behavior —
    # the reference errors out on such paths (video_exts.rs:4-6).
    ("mkv", "m2ts", "mts", "ts", "mpg", "wmv", "qt")
)


def is_video_ext(ext: str) -> bool:
    return ext.lower().lstrip(".") in VIDEO_EXTS
