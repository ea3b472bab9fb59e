"""Text post-processing: Traditional->Simplified Chinese, punctuation strip.

A copy of ``whisper_tpu/text.py``: the port keeps its own copy of the host-side
text stage.

The reference post-processes zh output with zhconv (python/whisper.py:264-269)
or OpenCC + dictionaries (cpp/src/Whisper.cpp:224-235, cpp/opencc/). This is a
dependency-free char-level converter covering the common traditional forms;
it is the host-side pipeline stage the serving path applies after detokenize.
"""

from __future__ import annotations

import re
from typing import Dict

# Character-level Traditional -> Simplified map (common subset of the public
# OpenCC TSCharacters table). Char-level conversion is what zhconv does for
# the vast majority of text; phrase-level disambiguation is intentionally
# omitted (rarely triggered by ASR output).
_T2S_PAIRS = (
    "萬万與与醜丑專专業业叢丛東东絲丝丟丢兩两嚴严喪丧個个豐丰臨临為为麗丽舉举麼么義义烏乌樂乐喬乔習习鄉乡書书買买亂乱爭争於于虧亏雲云亙亘亞亚產产畝亩親亲褻亵億亿僅仅從从倫仑倉仓儀仪們们價价眾众優优會会傴伛傘伞偉伟傳传傷伤倀伥倆俩傖伧偽伪佇伫體体餘余傭佣僉佥俠侠侶侣僥侥偵侦側侧僑侨儈侩儕侪儂侬俁俣儔俦儼俨倖幸儷俪儉俭債债傾倾傯偬僂偻剝剥償偿儻傥儐傧儲储儺傩懲惩劏㓥劊刽劌刿剛刚劍剑剮剐劇剧勸劝辦办務务勱劢動动勵励勁劲勞劳勢势勳勋猛猛勩勚匭匦匯汇匱匮區区醫医華华協协單单賣卖盧卢鹵卤臥卧衛卫廠厂廳厅歷历厲厉壓压厭厌厙厍參参靉叆靆叇雙双發发變变敘叙疊叠葉叶號号嘆叹嘰叽吃吃後后嚇吓呂吕嗎吗唚吣噸吨聽听啟启吳吴嘸呒囈呓嘔呕嚦呖唄呗員员咼呙嗆呛嗚呜詠咏嚨咙嚀咛噝咝吒咤鹹咸響响啞哑噠哒嘵哓嗶哔噦哕噲哙嘮唠啢唡喚唤嘖啧嗩唢啟唘唄唝嘩哗噴喷嚌哜嚶嘤嘗尝嚕噜嘯啸嘰叽團团園园囪囱圍围圇囵國国圖图圓圆聖圣壙圹場场阪坂壞坏塊块堅坚壇坛壢坜壩坝塢坞墳坟墜坠垻坝垵埯垅垄壟垄塒埘塤埙墊垫埡垭墾垦堖垴壋垱塏垲堝埚壪塆殼壳壺壶壯壮聲声殻壳複复夠够頭头誇夸奪夺奩奁奮奋獎奖妝妆婦妇媽妈嫵妩嫗妪媯妫姍姗姜姜婁娄婭娅嬈娆嬌娇孌娈娛娱媧娲嫻娴嬰婴嬋婵嬸婶嬡嫒嬪嫔嬙嫱嬤嬷孫孙學学孿孪寧宁寶宝實实寵宠審审憲宪宮宫寬宽賓宾寢寝對对尋寻導导壽寿將将爾尔塵尘嘗尝層层屆届屍尸屓屃屢屡屬属嶼屿歲岁豈岂嶇岖崗岗峴岘嵐岚島岛嶺岭崬岽巔巅鞏巩幣币帥帅師师幃帏帳帐簾帘幟帜帶带幀帧幫帮幬帱幗帼冪幂幹干並并廣广莊庄慶庆廬庐廡庑庫库應应廟庙龐庞廢废開开異异棄弃張张彌弥弳弪彎弯歸归當当錄录彥彦徹彻徑径徠徕禦御憶忆懺忏憂忧愾忾懷怀態态慫怂憮怃慪怄悵怅愴怆憐怜總总懟怼懌怿恆恒戀恋懇恳惡恶慟恸懨恹愷恺惻恻惱恼惲恽悅悦愨悫懸悬慳悭憫悯驚惊懼惧慘惨懲惩憊惫愜惬慣惯湣愍憤愤憒愦願愿懾慑憷怵懶懒懍懔戇戆戔戋戲戏戧戗戰战戩戬戶户紮扎撲扑扡扦執执擴扩捫扪掃扫揚扬擾扰撫抚拋抛摶抟摳抠掄抡搶抢護护報报擔担擬拟攏拢揀拣擁拥攔拦擰拧撥拨擇择掛挂摯挚攣挛撾挝撻挞挾挟撓挠擋挡撟挢掙挣擠挤揮挥撈捞損损撿捡換换搗捣摑掴擄掳摜掼據据擲掷摻掺摜掼攬揽撣掸攙搀擱搁摟搂攪搅攜携攝摄攄摅擺摆搖摇擯摈攤摊撐撑攆撵擷撷擼撸攛撺擻擞攢攒敵敌斂敛數数齋斋斕斓鬥斗斬斩斷断無无舊旧時时曠旷暘旸昇升曇昙晝昼曨昽顯显晉晋曬晒曉晓曄晔暈晕暉晖暫暂曖暧書书會会朧胧術术樸朴機机殺杀雜杂權权條条來来楊杨榪杩傑杰極极構构樅枞樞枢棗枣櫪枥梘枧棖枨槍枪楓枫樣样桿杆檔档柵栅標标棧栈櫛栉櫳栊棟栋樹树櫸榉檢检櫺棂橢椭樓楼欖榄櫬榇櫚榈櫟栎橫横檣樯檁檩橋桥樺桦檜桧槳桨椿椿樁桩夢梦檮梼棶梾檯台橈桡植植殲歼歿殁殤殇殘残殞殒殮殓殫殚殯殡毆殴毀毁轂毂畢毕斃毙氈毡毿毵氣气氫氢氬氩氳氲匯汇漢汉污污湯汤洶汹決决沒没灃沣滄沧溝沟滬沪濘泞淚泪澩泶瀧泷瀘泸濼泺潑泼澤泽涇泾潔洁灑洒窪洼浹浃淺浅漿浆澆浇湞浈濁浊測测澮浍濟济瀏浏滻浐渾浑濃浓淀淀潯浔濤涛澇涝淶涞漣涟潤润澗涧漲涨澀涩淵渊淥渌漬渍瀆渎漸渐澠渑漁渔瀋沈滲渗溫温遊游灣湾濕湿潰溃濺溅漵溆漤漤潷滗滾滚滯滞灩滟灄滠滿满瀅滢濾滤濫滥灤滦濱滨灘滩澦滪瀠潆瀟潇瀲潋濰潍潛潜瀦潴瀾澜瀨濑瀕濒灝灏滅灭燈灯靈灵災灾燦灿煬炀爐炉燉炖煒炜熗炝點点煉炼熾炽爍烁爛烂烴烃燭烛煙烟煩烦燒烧燁烨燴烩燙烫燼烬熱热煥焕燜焖愛爱爺爷牘牍犛牦牽牵犢犊狀状獷犷獁犸猶犹狽狈麅狍獮狝獰狞獨独狹狭獅狮獪狯猙狰獄狱猻狲獫猃獵猎貓猫蝟猬獻献獼猕玀猡現现瑪玛璣玑璵玙瑒玚瑲玱玨珏琿珲璉琏瑣琐瓊琼瑤瑶璦瑷璿璇瓔璎環环璽玺瓚瓒甌瓯電电畫画暢畅疇畴癤疖療疗瘧疟癘疠瘍疡鬁疬瘡疮瘋疯皰疱痙痉癢痒瘂痖癆痨瘓痪癇痫痴痴瘺瘘癱瘫癮瘾癩癞癬癣癲癫皚皑皺皱盞盏鹽盐監监蓋盖盜盗盤盘瞘眍眥眦矓眬眾众睏困瞼睑瞞瞒矚瞩矯矫磯矶礬矾礦矿碭砀碼码磚砖硯砚砲炮礪砺礱砻礫砾礎础硜硁碩硕硤硖磽硗磣碜確确鹼碱礙碍磧碛磐磐禮礼禰祢禎祯禱祷禍祸稟禀祿禄禪禅離离禿秃秈籼種种積积稱称穢秽穠秾穭穞稅税穌稣穩稳穀谷稈秆窮穷竊窃竅窍窯窑窩窝窺窥竇窦窶窭豎竖競竞篤笃筍笋筆笔筧笕箋笺籠笼籩笾築筑篳筚篩筛簹筜箏筝籌筹簽签簡简箇个籙箓簀箦篋箧籜箨籮箩簞箪簫箫簣篑簍篓籃篮籬篱籪簖籟籁籲吁類类秈籼糶粜糲粝粵粤糞粪糧粮糰团糝糁緊紧縶絷糸纟糾纠紆纡紅红紂纣纖纤紇纥約约級级紈纨纊纩紀纪紉纫緯纬紜纭純纯紕纰紗纱綱纲納纳縱纵綸纶紛纷紙纸紋纹紡纺紵纻紖纼紐纽紓纾線线紺绀絏绁紱绂練练組组紳绅細细織织終终縐绉絆绊紼绋絀绌紹绍繹绎經经紿绐綁绑絨绒結结繞绕絰绖絎绗繪绘給给絢绚絳绛絡络絕绝絞绞統统綆绠綃绡絹绢繡绣綌绤綏绥絛绦繼继綈绨績绩緒绪綾绫緓绬續续綺绮緋绯綽绰緄绲繩绳維维綿绵綬绶繃绷綢绸綯绹綹绺綣绻綜综綻绽綰绾綠绿綴缀緇缁緙缂緗缃緘缄緬缅緹缇緲缈緝缉緼缊緦缌緞缎緶缏線缐緱缑縋缒緩缓締缔縷缕編编緡缗緣缘縉缙縛缚縟缛縝缜縫缝縞缟纏缠縭缡縊缢縑缣繽缤縹缥縵缦縲缧纓缨縮缩繆缪繅缫纖纤繚缭繢缋繒缯繾缱繰缲繯缳繳缴罈坛罌罂網网羅罗罰罚罷罢羆罴羈羁羋芈羥羟義义羨羡翹翘耮耢聶聂聾聋職职聹聍聯联聵聩聰聪肅肃腸肠膚肤骯肮餚肴腎肾腫肿脹胀脅胁脈脉膾脍臍脐腦脑膿脓臠脔腳脚脛胫臟脏臉脸膽胆勝胜朧胧騰腾臘腊醃腌鯰鲶膠胶膩腻"
    "興兴舉举艤舣艦舰艙舱艫舻艱艰豔艳藝艺節节羋芈薌芗蕪芜蘆芦蓯苁葦苇藶苈莧苋萇苌蒼苍苧苎蘇苏檾苘蘋苹範范莖茎蠆虿蔦茑榮荣葒荭蕎荞薈荟薺荠蕩荡滎荥犖荦熒荧蕁荨藎荩蓀荪蔭荫蕒荬葤荮藥药萊莱蓮莲蒔莳萵莴薟莶獲获蕕莸瑩莹鶯莺蓴莼蘿萝螢萤營营縈萦蕭萧薩萨蔥葱蕆蒇蕢蒉蔣蒋蔞蒌藍蓝薊蓟蘺蓠蒞莅蘄蕲蔔卜蘺蓠薔蔷藹蔼蘞蔹藺蔺藪薮蘚藓蘊蕴處处虛虚虜虏慮虑虯虬蟲虫蝦虾蠍蝎蠔蚝螄蛳蠣蛎蟶蛏蠅蝇蟻蚁蟄蛰蠱蛊蜆蚬蝸蜗蠟蜡蠻蛮蠶蚕蠐蛴蛺蛱蟯蛲螻蝼蟈蝈蠑蝾螞蚂蟣虮衊蔑術术銜衔補补襯衬袞衮襖袄嫋袅褘袆襪袜襲袭裝装襠裆褳裢襝裣褲裤褸褛襤褴見见觀观規规覓觅視视覘觇覽览覺觉覬觊覡觋覿觌覥觍覦觎親亲覲觐覷觑觴觞觸触觶觯訁讠計计訂订訃讣認认譏讥訐讦訌讧討讨讓让訕讪訖讫訓训議议訊讯記记講讲諱讳謳讴詎讵訝讶訥讷許许訛讹論论訩讻訟讼諷讽設设訪访訣诀證证詁诂訶诃評评詛诅識识詗诇詐诈訴诉診诊詆诋謅诌詞词詘诎詔诏譯译詒诒誆诓誄诔試试詿诖詩诗詰诘誇夸詼诙誠诚誅诛話话誕诞詬诟詮诠詭诡詢询詣诣諍诤該该詳详詫诧諢诨詡诩誡诫誣诬語语誚诮誤误誥诰誘诱誨诲誑诳說说誦诵誒诶請请諸诸諏诹諾诺讀读諑诼誹诽課课諉诿諛谀誰谁諗谂調调諂谄諒谅諄谆談谈誼谊謀谋諶谌諜谍謊谎諫谏諧谐謔谑謁谒謂谓諤谔諭谕諼谖諷讽諮谘諳谙諺谚諦谛謎谜諞谝謨谟讜谠謖谡謝谢謠谣謗谤謚谥謙谦謐谧謹谨謾谩謫谪謬谬譚谭譖谮譙谯讕谰譜谱譎谲讞谳譴谴譫谵讖谶谷谷豐丰豬猪豶豮貝贝貞贞負负貟贠貢贡財财責责賢贤敗败賬账貨货質质販贩貪贪貧贫貶贬購购貯贮貫贯貳贰賤贱賁贲貰贳貼贴貴贵貺贶貸贷貿贸費费賀贺貽贻賊贼贄贽賈贾賄贿貲赀賃赁賂赂贓赃資资賅赅贐赆賕赇賑赈賚赉賒赊賦赋賭赌贖赎賞赏賜赐贔屃賙赒賠赔賧赕賴赖賵赗贅赘賻赙賺赚賽赛賾赜贗赝贊赞贇赟贈赠贍赡贏赢赬赪趙赵趕赶趨趋趲趱躉趸躍跃蹌跄蹣跚躒跞踐践躂跶蹺跷蹕跸躚跹躋跻踴踊躊踌蹤踪躓踬躑踯躡蹑蹣蹒躕蹰躥蹿躪躏躦躜軀躯車车軋轧軌轨軒轩軑轪軔轫轉转軛轭輪轮軟软轟轰軲轱軻轲轤轳軸轴軹轵軼轶軤轷軫轸轢轹軺轺輕轻軾轼載载輊轾轎轿輈辀輇辁輅辂較较輒辄輔辅輛辆輦辇輩辈輝辉輥辊輞辋輟辍輜辎輳辏輻辐輯辑輸输轡辔轅辕轄辖輾辗轆辘轍辙轔辚辭辞辮辫辯辩農农邊边遼辽達达遷迁過过邁迈運运還还這这進进遠远違违連连遲迟邇迩逕迳跡迹適适選选遜逊遞递邐逦邏逻遺遗遙遥鄧邓鄺邝鄔邬郵邮鄒邹鄴邺鄰邻鬱郁郟郏鄶郐鄭郑鄆郓酈郦鄖郧鄲郸醞酝醱酦醬酱釅酽釃酾釀酿釋释裏里鑒鉴鑾銮鏨錾釓钆釔钇針针釘钉釗钊釙钋釕钌釷钍釺钎釧钏釤钐釣钓釩钒釹钕釵钗鈣钙鈍钝鈔钞鐘钟鈉钠鋇钡鋼钢鈑钣鈐钤鑰钥欽钦鈞钧鎢钨鈎钩鈧钪鈁钫鈥钬鈄钭鈕钮鈀钯鈺钰錢钱鉦钲鉗钳鈷钴缽钵鈳钶鉕钷鈽钸鈸钹鉞钺鑽钻鉬钼鉭钽鉀钾鈿钿鈾铀鐵铁鉑铂鈴铃鉛铅鉚铆鈰铈鉉铉鉈铊鉍铋鈮铌鈹铍鐸铎鉶铏銬铐銠铑鉺铒銪铕鋁铝銅铜銱铞銦铟鎧铠鍘铡銖铢銑铣鋌铤銩铥鏵铧銓铨鉿铪銚铫鉻铬銘铭錚铮銫铯鉸铰銥铱鏟铲銃铳鐃铙銨铵銀银銣铷鑄铸鐒铹鋪铺鋙铻錸铼鋱铽鏈链鏗铿銷销鎖锁鋰锂鋥锃鋤锄鍋锅鋯锆鋨锇鏽锈銹锈鋒锋鋅锌鋶锍鐦锎鐧锏銳锐銻锑鋃锒鋟锓鏤镂鋸锯鋼钢錳锰錙锱鍺锗錯错錨锚錛锛錡锜鍀锝錁锞錕锟錫锡錮锢鑼锣錘锤錐锥錦锦鍁锨錇锫錈锩錟锬錠锭鍵键錄录鋸锯錳锰鍶锶鍔锷鍤锸鍬锹鍛锻鎪锼鍠锽鎄锿鎂镁鏤镂鎡镃鎮镇鎛镈鎘镉鑷镊鐫镌鎳镍鎿镎鎦镏鎬镐鎊镑鎰镒鎵镓鑌镔鏢镖鏜镗鏍镙鏰镚鏞镛鏡镜鏑镝鏃镞鏇旋鏐镠鐔镡鐓镦鐘钟鐠镨鐒铹鐋铴鐲镯鐮镰鐿镱鑔镲钁镢钃镧鑠铄長长門门閂闩閃闪閉闭問问闖闯閏闰闈闱閑闲閎闳間间閔闵閌闶悶闷閘闸鬧闹閨闺聞闻闼闼閩闽閭闾閥阀閣阁閡阂閫阃鬮阄閱阅閬阆閾阈閹阉閶阊鬩阋閿阌閽阍閻阎閼阏闡阐闌阑闃阒闊阔闋阕闔阖闐阗闕阙闖闯關关闞阚闤阛隊队陽阳陰阴陣阵階阶際际陸陆隴陇陳陈陘陉陝陕隉陧隕陨險险隨随隱隐隸隶雋隽難难雛雏讎雠靂雳霧雾霽霁黴霉靄霭靜静靚靓面面靨靥韃鞑鞽鞒韉鞯韋韦韓韩韙韪韞韫韻韵頁页頂顶頃顷頇顸項项順顺須须頊顼頑顽顧顾頓顿頎颀頒颁頌颂頏颃預预顱颅領领頗颇頸颈頡颉頰颊頜颌潁颍頦颏頤颐頻频頷颔頭头頹颓頮颒頴颕穎颖顆颗題题顎颚顓颛顏颜額额顳颞顢颟顛颠顙颡顥颢纇颣顫颤顬颥顰颦風风颳刮颶飓颸飔颼飕飄飘飆飙飛飞饗飨餐餐飣饤饑饥飥饦餳饧飩饨飪饪飫饫飭饬飯饭飲饮餞饯飾饰飽饱飼饲飿饳飴饴餌饵饒饶餉饷餃饺餅饼餑饽餓饿餒馁餘余餒馁餛馄餡馅館馆餷馇餿馊饞馋饃馍餾馏饈馐饉馑饅馒饊馓饌馔饢馕馬马馭驭馱驮馴驯馳驰驅驱駁驳駑驽駕驾駟驷駙驸駒驹駐驻駝驼駘骀驀蓦騁骋駿骏騏骐騎骑騍骒騅骓驂骖驕骄驊骅騷骚騖骛驁骜騮骝騫骞騸骟驃骠驄骢驏骣驛驿駡骂驢驴驟骤驥骥骨骨骯肮髏髅髖髋髕髌鬢鬓魎魉魘魇魚鱼魷鱿魯鲁鮁鲅鮃鲆鮎鲇鮋鲉鮊鲌鮍鲏鮐鲐鮑鲍鮒鲋鮓鲊鮚鲒鮜鲘鮝鲞鮞鲕鮦鲖鮪鲔鮫鲛鮭鲑鮮鲜鮳鲓鮶鲪鮺鲝鯀鲧鯁鲠鯇鲩鯉鲤鯊鲨鯒鲬鯔鲻鯕鲯鯖鲭鯗鲞鯛鲷鯝鲴鯡鲱鯢鲵鯤鲲鯧鲳鯨鲸鯪鲮鯫鲰鯰鲶鯛鲷鯴鲺鯷鳀鯽鲫鯿鳊鰁鳈鰂鲗鰃鳂鰈鲽鰉鳇鰍鳅鰏鲾鰐鳄鰒鳆鰓鳃鰟鳑鰠鳋鰣鲥鰥鳏鰨鳎鰩鳐鰭鳍鰱鲢鰲鳌鰳鳓鰵鳘鰷鲦鰹鲣鰺鲹鰻鳗鰼鳛鰾鳔鱈鳕鱉鳖鱒鳟鱔鳝鱖鳜鱗鳞鱘鲟鱟鲎鱠鲙鱧鳢鱭鲚鱷鳄鱸鲈鱺鲡鳥鸟鳩鸠雞鸡鳶鸢鳴鸣鳲鸤鷗鸥鴉鸦鶬鸧鴇鸨鴆鸩鴣鸪鶇鸫鸕鸬鴨鸭鴞鸮鴦鸯鴛鸳鴟鸱鴝鸲鴕鸵鷥鸶鷙鸷鴯鸸鴰鸹鵂鸺鴴鸻鵃鸼鴿鸽鸞鸾鴻鸿鵐鹀鵓鹁鸝鹂鵑鹃鵠鹄鵝鹅鵒鹆鷳鹇鵜鹈鵡鹉鵲鹊鶓鹋鵪鹌鵯鹎鵬鹏鵮鹐鶉鹑鶊鹒鶘鹕鶚鹗鶻鹘鶿鹚鶥鹛鶩鹜鷂鹞鶼鹣鶴鹤鷁鹢鷃鹂鷓鹧鷚鹨鷯鹩鷦鹪鷲鹫鷸鹬鷺鹭鷹鹰鸌鹱鸏鹏麥麦麩麸黃黄黌黉點点黶黡黷黩黲黪黽黾黿鼋鼉鼍鼴鼹齊齐齋斋齏齑齒齿齔龀齙龅齜龇齟龃齡龄齠龆齦龈齪龊齬龉齲龋齷龌龍龙龔龚龕龛龜龟"
)

_T2S_EXTRA = (
    "幾几況况隻只颱台鬆松裡里裏里係系嚮向捨舍鞦秋韆千瀋沈啓启衹只纔才"
    "麵面鬚须籲吁徵征儘尽啥啥嘛嘛喫吃傢家倆俩儿儿"
    # high-frequency chars absent from the base pair table (audited against
    # the public OpenCC TSCharacters mapping)
    "寫写歡欢驗验牆墙彙汇錶表閒闲劑剂別别竈灶竄窜衝冲墮堕騙骗鬍胡兒儿"
    "兌兑內内冊册憑凭凍冻減减湊凑凜凛鳳凤鳧凫凱凯擊击鑿凿劉刘則则剎刹"
    "創创劃划廁厕壚垆壘垒尷尴盡尽嶄崭嶽岳廈厦彈弹強强復复欄栏瀉泻爲为"
    "甕瓮祕秘綫线罵骂臺台蘭兰衆众製制誌志軍军迴回鑑鉴闆板馮冯駛驶髒脏"
    "黨党雖虽諮咨"
)

T2S: Dict[str, str] = {}
for _i in range(0, len(_T2S_PAIRS) - 1, 2):
    _t, _s = _T2S_PAIRS[_i], _T2S_PAIRS[_i + 1]
    if _t != _s:
        T2S[_t] = _s
# curated overrides/additions win over the base pair table
for _i in range(0, len(_T2S_EXTRA) - 1, 2):
    _t, _s = _T2S_EXTRA[_i], _T2S_EXTRA[_i + 1]
    if _t != _s:
        T2S[_t] = _s

# Ambiguous traditional chars: their correct simplified form depends on the
# word — the char table above deliberately omits them; they get a most-common
# default here plus phrase-level exceptions below (the role OpenCC's
# TSPhrases dictionary plays in the reference, cpp/src/Whisper.cpp:224-235).
_T2S_AMBIG = {
    "乾": "干",  # dry (乾燥→干燥) — but the Qianlong/qián senses keep 乾
    "著": "着",  # aspect particle (看著→看着) — but zhù senses keep 著
    "瞭": "了",  # 瞭解→了解 — but 瞭望 keeps 瞭
    "藉": "借",  # 藉口→借口 — but 狼藉/慰藉 keep 藉
    "髮": "发",  # hair (頭髮→头发); 發→发 is already in the char table
    "鍾": "钟",  # 鍾情→钟情 (the surname locally keeps 锺 — rare in ASR)
    "祇": "只",  # 祇有→只有 — but 神祇 keeps 祇
}
T2S.update(_T2S_AMBIG)

# Phrase exceptions (traditional spelling -> correct simplified), applied by
# greedy longest-match BEFORE the char map. Identity values protect words
# whose ambiguous char must NOT take the default above.
T2S_PHRASES: Dict[str, str] = {
    # 乾 qián senses stay 乾
    "乾隆": "乾隆", "乾坤": "乾坤", "乾卦": "乾卦", "乾嘉": "乾嘉",
    "乾陵": "乾陵", "乾縣": "乾县",
    # 著 zhù senses stay 著
    "著名": "著名", "著作": "著作", "著述": "著述", "著錄": "著录",
    "著稱": "著称", "著者": "著者", "著書": "著书", "著有": "著有",
    "顯著": "显著", "昭著": "昭著", "卓著": "卓著", "土著": "土著",
    "編著": "编著", "名著": "名著", "原著": "原著", "專著": "专著",
    "論著": "论著", "巨著": "巨著", "譯著": "译著", "執著": "执著",
    # 瞭 liào senses stay 瞭
    "瞭望": "瞭望", "瞭哨": "瞭哨",
    # 藉 jí / formal jiè senses stay 藉
    "狼藉": "狼藉", "蘊藉": "蕴藉", "慰藉": "慰藉", "枕藉": "枕藉",
    # 覆 "reply" sense simplifies to 复 (char default keeps 覆 for cover)
    "答覆": "答复", "回覆": "回复", "批覆": "批复", "覆信": "复信",
    "覆命": "复命", "反覆": "反复",
    # 祇 deity sense stays 祇
    "神祇": "神祇",
    # 鍾 surname convention
    "鍾氏": "锺氏",
    # 噸/裡-style words whose chars differ by context
    "皇後": "皇后",  # defensive: 後→后 is contextless, 皇后 already correct
}
_MAX_PHRASE = max(len(k) for k in T2S_PHRASES)


def t2s_char(text: str) -> str:
    """Traditional -> Simplified Chinese, char-level only."""
    return "".join(T2S.get(ch, ch) for ch in text)


def t2s(text: str) -> str:
    """Traditional -> Simplified Chinese: greedy longest-match over the
    phrase table, char map otherwise (OpenCC-style maximum forward match)."""
    out = []
    i = 0
    n = len(text)
    while i < n:
        hit = None
        for ln in range(min(_MAX_PHRASE, n - i), 1, -1):
            cand = text[i : i + ln]
            if cand in T2S_PHRASES:
                hit = T2S_PHRASES[cand]
                i += ln
                break
        if hit is None:
            hit = T2S.get(text[i], text[i])
            i += 1
        out.append(hit)
    return "".join(out)


_PUNCT_RE = re.compile(
    "[,\\.!\\?;:\"'`~@#\\$%\\^&\\*\\(\\)\\[\\]\\{\\}<>/\\\\\\|\\-_=\\+"
    "，。！？；：、"  # ，。！？；：、
    "“”‘’"  # curly quotes
    "【】《》（）…—·\\s]"
)


def remove_punctuation(text: str) -> str:
    """Strip punctuation + whitespace (WER normalization, reference
    python/test_wer.py:238-246)."""
    return _PUNCT_RE.sub("", text)


def parse_segments(text_with_timestamps: str):
    """Split a `<|t0|>text<|t1|>` transcript into [(start_s, end_s, text)].

    Structured segment output like OpenAI whisper's result dict — the
    reference returns flat text only.
    """
    parts = re.split(r"<\|(\d+\.\d+)\|>", text_with_timestamps)
    segments = []
    # parts alternates: text, ts, text, ts, ...
    current_start = None
    for i in range(1, len(parts), 2):
        ts = float(parts[i])
        trailing = parts[i + 1] if i + 1 < len(parts) else ""
        if current_start is None:
            current_start = (ts, trailing)
        else:
            start_ts, seg_text = current_start
            if seg_text.strip():
                segments.append((start_ts, ts, seg_text.strip()))
            current_start = (ts, trailing)
    if current_start is not None and current_start[1].strip():
        segments.append((current_start[0], None, current_start[1].strip()))
    return segments


def remove_punctuation_keep_spaces(text: str) -> str:
    """Strip punctuation but keep word boundaries (word-level WER)."""
    out = _PUNCT_RE.sub(" ", text)
    return " ".join(out.split()).lower()


def postprocess(text: str, language: str) -> str:
    """Serving-side text post-processing stage (python/whisper.py:262-269)."""
    text = text.strip()
    if language in ("zh", "yue"):
        text = t2s(text)
    return text
