from . import circor, pascal, physionet16, zchsound
